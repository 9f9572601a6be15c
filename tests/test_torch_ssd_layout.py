"""B5's entry point in the models' layout, ``ssd_scan_heads``, on the CPU:
x (B, S, H, P), dt (B, S, H), A (H,), B and C (B, S, G, N) with head h
reading group h // (H // G), y (B, S, H, P) and the final state (B, H,
N, P).

* Its plain version against the reference's ``ssd_chunked`` run live,
  at one and several B/C groups, with and without an initial state,
  within 1e-5 (the tolerance of ``test_torch_mamba2.py``'s
  ``ssd_chunked`` parity: the same float32 math in another summation
  order); and bit for bit the (BH, S, P) route it replaces (the rows,
  x * dt and ``ssd_scan_plain``), on contiguous operands and on views of
  a wider buffer (the mixer's float32 slices of its projection).
* Every refusal of a launch (``launch_strides``, on metadata alone):
  an unbuilt (P, N), heads not a multiple of the groups, strides TMA
  cannot take, a misaligned base, S not a multiple of the chunk, a chunk
  over 256, a recorded gradient, another dtype; the wrapper raises
  before it reaches the launch (a spy in its place), and reaches it for
  the operands the serves pass.
* Meta operands (the dry run): the outputs' shapes, and the scratch the
  launch would take allocated for the call.
* The mixer's prefill on meta operands makes no x-sized ``mul``,
  ``copy_`` or ``clone`` around the call (no x * dt, no row copies, y's
  reshape a view), and passes the kernel its views of the projection.

The card tests (``tests/test_torch_cuda.py``) hold the kernel to this
plain version within the kernel's tolerance.
"""
import dataclasses
import traceback
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs, rng
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import mamba2
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _operands(seed, B, S, H, P, G, N, init=False):
    """x, dt, A, B, C (and the initial state) as numpy float32, drawn as
    the mixer makes them: dt a softplus, A negative."""
    rs = np.random.default_rng(seed)
    x = 0.5 * rs.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rs.standard_normal((B, S, H))))
    A = -np.linspace(0.2, 1.2, H)
    Bm = 0.5 * rs.standard_normal((B, S, G, N))
    Cm = 0.5 * rs.standard_normal((B, S, G, N))
    st = rs.standard_normal((B, H, N, P)) if init else None
    return [None if a is None else np.asarray(a, np.float32)
            for a in (x, dt, A, Bm, Cm, st)]


def _rows_route(x, dt, A, Bm, Cm, chunk, init=None):
    """The (BH, S, P) route the mixer took before: heads flattened into
    rows, x * dt and dA formed in float32, ``ssd_scan_plain`` with the
    heads of a group reading its B and C, y permuted back."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2:]

    def rows(t):
        return t.permute(0, 2, 1, 3).reshape(-1, S, t.shape[-1])

    y, st = ss.ssd_scan_plain(
        rows(x * dt[..., None]).contiguous(), rows(Bm).contiguous(),
        rows(Cm).contiguous(),
        (dt * A).permute(0, 2, 1).reshape(B_ * H, S).contiguous(), chunk,
        H // G, None if init is None else init.reshape(B_ * H, N, P))
    return (y.reshape(B_, H, S, P).permute(0, 2, 1, 3),
            st.reshape(B_, H, N, P))


# (B, S, H, P, G, N, chunk): one group, several, a head a group, a chunk
# no multiple of 64, the serve's (P, N) at a short S
CASES = [(2, 96, 4, 16, 1, 8, 32), (2, 96, 4, 16, 2, 8, 32),
         (1, 128, 6, 8, 3, 4, 64), (2, 64, 4, 32, 4, 16, 32),
         (1, 96, 4, 8, 2, 4, 96), (1, 64, 2, 64, 1, 128, 64)]


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", CASES)
def test_heads_plain_matches_reference_ssd_chunked(B, S, H, P, G, N, chunk,
                                                   with_init):
    ref = load_reference()
    x, dt, A, Bm, Cm, init = _operands(S + 7 * G + P, B, S, H, P, G, N,
                                       with_init)
    yj, fj = ref.mamba2.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init))
    y, st = ss.ssd_scan_heads_plain(
        *(torch.tensor(a) for a in (x, dt, A, Bm, Cm)), chunk,
        None if init is None else torch.tensor(init))
    assert tuple(y.shape) == (B, S, H, P) and tuple(st.shape) == (B, H, N, P)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **F32_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(fj), **F32_TOL)


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", CASES[:3])
def test_heads_entry_is_the_rows_route_bit_for_bit(B, S, H, P, G, N, chunk,
                                                   with_init):
    """On the CPU the entry is its plain version, and that is the (BH, S,
    P) route it replaces, bit for bit."""
    ops = [None if a is None else torch.tensor(a)
           for a in _operands(S + G, B, S, H, P, G, N, with_init)]
    x, dt, A, Bm, Cm, init = ops
    y, st = ss.ssd_scan_heads(x, dt, A, Bm, Cm, chunk, init, final=True)
    want_y, want_st = _rows_route(x, dt, A, Bm, Cm, chunk, init)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    assert torch.equal(ss.ssd_scan_heads(x, dt, A, Bm, Cm, chunk, init), y)


def _projection(B, S, H, P, G, N, seed=0):
    """The mixer's float32 operands: x, B and C views of one (B, S, H P +
    2 G N) buffer (its conv output, each in its own strides), dt the
    softplus of its own block."""
    rs = np.random.default_rng(seed)
    xbc = torch.tensor(rs.standard_normal((B, S, H * P + 2 * G * N)),
                       dtype=torch.float32)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(
        torch.tensor(rs.standard_normal((B, S, H)), dtype=torch.float32))
    return x, dt, Bm, Cm


def test_views_of_a_wider_buffer_equal_their_copies():
    B, S, H, P, G, N, chunk = 2, 64, 4, 16, 2, 8, 32
    x, dt, Bm, Cm = _projection(B, S, H, P, G, N)
    A = -torch.linspace(0.2, 1.2, H)
    assert not x.is_contiguous() and not Bm.is_contiguous()
    got = ss.ssd_scan_heads(x, dt, A, Bm, Cm, chunk, final=True)
    want = ss.ssd_scan_heads(x.contiguous(), dt, A, Bm.contiguous(),
                             Cm.contiguous(), chunk, final=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_launch_takes_the_models_layout_and_views():
    """The element strides of a launch ((t, head or group, batch) of x,
    B, C, dt and y): contiguous operands, the mixer's views of its
    conv output (each row H P + 2 G N floats), and the (BH, S, P)
    rows' batch of one, whose stride is never read."""
    B, S, H, P, G, N = 2, 64, 4, 16, 2, 8
    x = torch.zeros(B, S, H, P)
    dt = torch.zeros(B, S, H)
    A = torch.zeros(H)
    Bm = torch.zeros(B, S, G, N)
    assert ss.launch_strides(x, dt, A, Bm, Bm, 32) == [
        64, 16, 4096, 16, 8, 1024, 16, 8, 1024, 4, 1, 256, 64, 16, 4096]
    x, dt, Bm, Cm = _projection(B, S, H, P, G, N)
    row = H * P + 2 * G * N         # 96 floats: 384 bytes
    assert ss.launch_strides(x, dt, A, Bm, Cm, 32) == [
        row, P, S * row, row, N, S * row, row, N, S * row, H, 1, S * H,
        64, 16, 4096]
    flat = torch.zeros(1, S, 8, P)
    assert ss.launch_strides(flat, torch.zeros(1, S, 8), torch.zeros(8),
                             torch.zeros(1, S, 8, N), torch.zeros(1, S, 8, N),
                             32)[:3] == [8 * P, P, 4]


def _valid(B=2, S=64, H=4, P=16, G=2, N=8):
    return (torch.zeros(B, S, H, P), torch.zeros(B, S, H), -torch.ones(H),
            torch.zeros(B, S, G, N), torch.zeros(B, S, G, N))


class _Spy:
    """Stands in for the kernel's launch: counts the calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1


@pytest.fixture
def spy(monkeypatch):
    """CPU operands taken as if they lay on the card: the wrapper runs
    its checks and reaches the launch, which a spy replaces."""
    s = _Spy()
    monkeypatch.setattr(ss, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ss.KERNEL, "launch", s)
    return s


def test_the_serves_operands_reach_the_launch(spy):
    x, dt, A, Bm, Cm = _valid()
    y, st = ss.ssd_scan_heads(x, dt, A, Bm, Cm, 32, final=True)
    assert spy.calls == 1
    assert tuple(y.shape) == (2, 64, 4, 16)
    assert tuple(st.shape) == (2, 4, 8, 16)
    x, dt, Bm, Cm = _projection(2, 64, 4, 16, 2, 8)
    ss.ssd_scan_heads(x, dt, A, Bm, Cm, 32, torch.zeros(2, 4, 8, 16))
    assert spy.calls == 2


REFUSALS = ["unbuilt", "groups", "stride", "expanded", "transposed",
            "misaligned", "s_chunk", "chunk", "grad", "dtype", "dt_dtype",
            "init"]


@pytest.mark.parametrize("case", REFUSALS)
def test_launch_refusals(case, spy):
    """Each operand the kernel cannot take raises ValueError on its
    metadata, before the launch."""
    x, dt, A, Bm, Cm = _valid()
    chunk, init = 32, None
    if case == "unbuilt":          # (P, N) = (24, 8)
        x = torch.zeros(2, 64, 4, 24)
    elif case == "groups":         # 4 heads over 3 groups
        Bm = Cm = torch.zeros(2, 64, 3, 8)
    elif case == "stride":         # heads 17 floats apart: 68 bytes
        x = torch.zeros(2, 64, 4, 17)[..., :16]
    elif case == "expanded":       # one group repeated by a 0 stride
        Bm = torch.zeros(2, 64, 1, 8).expand(2, 64, 2, 8)
    elif case == "transposed":     # not unit-stride in the state dim
        Cm = torch.zeros(2, 64, 8, 2).transpose(2, 3)
    elif case == "misaligned":     # 4 bytes off a 16-byte boundary
        x = torch.zeros(2 * 64 * 4 * 16 + 1)[1:].view(2, 64, 4, 16)
    elif case == "s_chunk":        # S 64 over chunks of 48
        chunk = 48
    elif case == "chunk":          # a chunk of 512
        x, dt, A, Bm, Cm = _valid(S=512)
        chunk = 512
    elif case == "grad":
        x = x.requires_grad_(True)
    elif case == "dtype":
        x, Bm, Cm = x.double(), Bm.double(), Cm.double()
    elif case == "dt_dtype":
        dt = dt.bfloat16()
    elif case == "init":           # a transposed initial state
        init = torch.zeros(2, 4, 16, 8).transpose(2, 3)
    with pytest.raises(ValueError):
        ss.ssd_scan_heads(x, dt, A, Bm, Cm, chunk, init)
    assert spy.calls == 0


def test_meta_operands_take_the_outputs_and_the_scratch():
    """The dry run's meta tensors: y (B, S, H, P), the state (B, H, N,
    P), and the launch's scratch allocated for the call (the dry run's
    memory count sees it), nothing computed."""
    B, S, H, P, G, N, chunk = 4, 4096, 80, 64, 1, 64, 256
    meta = dict(device="meta")
    x = torch.empty(B, S, H, P, **meta)
    dt = torch.empty(B, S, H, **meta)
    A = torch.empty(H, **meta)
    Bm = torch.empty(B, S, G, N, **meta)
    sizes = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.startswith(("empty", "new_empty")):
                sizes.append(tuple(out.shape))
            return out

    with Record():
        y, st = ss.ssd_scan_heads(x, dt, A, Bm, Bm, chunk, final=True)
    assert y.is_meta and tuple(y.shape) == (B, S, H, P)
    assert st.is_meta and tuple(st.shape) == (B, H, N, P)
    floats = ss.scratch_floats(B * H, S, P, N, chunk, H // G, with_dt=True)
    assert sizes == [(B, S, H, P), (B, H, N, P), (floats,)]
    y = ss.ssd_scan_heads(x[:, :512], dt[:, :512], A, Bm[:, :512],
                          Bm[:, :512], chunk)
    assert y.is_meta and tuple(y.shape) == (B, 512, H, P)


def _meta_mixer(cfg, B, S):
    """A mixer layer's weights and input on the meta device."""
    p = mamba2.init_mamba(cfg, rng.PRNGKey(0))
    p = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
         for k, v in p.items()}
    return p, torch.empty(B, S, cfg.d_model, device="meta")


@pytest.mark.parametrize("G,S", [(1, 64), (2, 64), (1, 40)])
def test_mixer_makes_no_copies_around_the_call(G, S, monkeypatch):
    """mamba2_forward's prefill (no grad, as the serve's step runs it) on
    meta operands, every aten call traced with the function of
    models/mamba2.py that made it: no x-sized mul made on the way to the
    kernel (``ssd_chunked`` and below), and no x-sized copy_ or clone
    anywhere in the mixer (the row copies, y's reshape); the mixer's own
    D x product is seen.  The kernel's entry gets x, B and C as views of
    the projection, dt as the mixer made it."""
    cfg = dataclasses.replace(configs.get_config("mamba2-370m").smoke(),
                              ssm_ngroups=G)
    B, H, P = 2, cfg.ssm_heads, cfg.ssm_head_dim
    passed = []
    entry = mamba2.ssd_scan_heads

    def spy_entry(x, dt, A, Bm, Cm, *args, **kw):
        passed.append((x.stride(), Bm.stride(), Cm.stride(), dt.shape))
        return entry(x, dt, A, Bm, Cm, *args, **kw)

    monkeypatch.setattr(mamba2, "ssd_scan_heads", spy_entry)
    p, xin = _meta_mixer(cfg, B, S)
    seen = Counter()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in ("mul", "copy_", "clone") and isinstance(
                    out, torch.Tensor) and out.numel() >= B * S * H * P:
                where = next((f.name for f in reversed(
                    traceback.extract_stack())
                    if f.filename.endswith("repro_torch/models/mamba2.py")),
                    "elsewhere")
                seen[(name, where)] += 1
            return out

    with torch.no_grad(), Record():
        out, _ = mamba2.mamba2_forward(cfg, p, xin)
    assert tuple(out.shape) == (B, S, cfg.d_model)
    around = {k: n for k, n in seen.items()
              if k[1] in ("ssd_chunked", "_ssd_chunked_scan", "_ssd_rows")
              or k[0] in ("copy_", "clone")}
    assert around == {}, seen
    assert seen[("mul", "mamba2_forward")] >= 1, seen   # D x, the gate
    Cd = cfg.d_inner + 2 * G * cfg.ssm_state
    if S % cfg.ssm_chunk == 0:    # the projection's views, unpadded
        assert passed == [((S * Cd, Cd, P, 1), (S * Cd, Cd, cfg.ssm_state, 1),
                           (S * Cd, Cd, cfg.ssm_state, 1), (B, S, H))]
    else:                          # padded to the chunk: copies by F.pad
        assert len(passed) == 1 and passed[0][3] == (B, 64, H)
