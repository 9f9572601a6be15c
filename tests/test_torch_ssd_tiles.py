"""The SSD scan kernel's algorithm, emulated on the CPU.

``csrc/ssd_scan.cu`` runs the chunked SSD on the tensor cores as three
passes: each chunk's own end state (B o w)^T x over 64-key tiles, a
sequential pass over the chunks for the state entering each, and per
64-query tile y = exp(seg) (C . S_prev) plus the key tiles at or below the
diagonal, (C . B^T masked before the exp, decayed) . x.  Every product is
3xTF32: a TF32 operand keeps the top 10 mantissa bits (the tensor core
drops the low 13), so each operand a is split into trunc(a) and
a - trunc(a), and trunc(a).trunc(b) + trunc(a).rest(b) + rest(a).trunc(b)
are summed in float32.  The card test (``tests/test_torch_cuda.py``)
holds the kernel to ``ssd_scan_plain`` at atol 2e-4 + rtol 1e-3, the
reference's own tolerance for its kernel.  Here an emulation of that
algorithm, written in this file and not in the package, meets the same
tolerance against ``ssd_scan_plain`` and against the reference's Pallas
kernel (interpret mode), at the card test's shapes; and a single TF32
product per operand pair misses it at the serve shape, which is why the
kernel pays for three.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ssd_scan_plain
from test_torch_reference import load_reference

T = 64                                # the kernel's query and key tiles
SSD_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_torch_cuda.py
SERVE = (128, 1024, 64, 128, 256, 32)  # mamba2-370m prefill, batch 4
SHAPES = [                            # tests/test_torch_cuda.py's cases
    SERVE,
    (32, 64, 32, 16, 32, 16),         # mamba2-370m smoke, prompt 40 padded
    (8, 512, 64, 128, 128, 1),        # a chunk below 256
    (1, 256, 64, 128, 256, 1),        # one row
    (2, 128, 32, 16, 32, 1),          # the reference's kernel test shapes
    (4, 256, 64, 32, 64, 1),
    (1, 64, 16, 8, 16, 1),
    (6, 96, 8, 4, 96, 2),             # a chunk that is no multiple of 64
]


def trunc(a):
    """a as the tensor core reads it in TF32: the low 13 mantissa bits
    dropped."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm(a, b, passes):
    """a @ b on TF32 operands with float32 sums: one product, or 3xTF32."""
    if passes == 1:
        return trunc(a) @ trunc(b)
    ab, bb = trunc(a), trunc(b)
    return trunc(a - ab) @ bb + ab @ trunc(b - bb) + ab @ bb


def emulate(xdt, Bh, Ch, dA, chunk, hpg=1, init=None, passes=3):
    """The kernel's three passes and tile order: (y, final state)."""
    bh, s, p = xdt.shape
    n = Bh.shape[-1]
    nc, L = s // chunk, chunk
    x = xdt.reshape(bh, nc, L, p)
    B, C = (t.repeat_interleave(hpg, 0).reshape(bh, nc, L, n)
            for t in (Bh, Ch))
    seg = dA.reshape(bh, nc, L).cumsum(-1)
    # (a) each chunk's own end state, over 64-key tiles
    w = torch.exp(seg[..., -1:] - seg)
    ends = torch.zeros(bh, nc, n, p)
    for k0 in range(0, L, T):
        bw = B[..., k0:k0 + T, :] * w[..., k0:k0 + T, None]
        ends = ends + mm(bw.transpose(-1, -2), x[..., k0:k0 + T, :], passes)
    # (b) the state entering each chunk
    state = torch.zeros(bh, n, p) if init is None else init
    prev = []
    for c in range(nc):
        prev.append(state)
        state = torch.exp(seg[:, c, -1])[:, None, None] * state + ends[:, c]
    prev = torch.stack(prev, 1)
    # (c) per 64-query tile: the inter term, then the key tiles at or
    # below the diagonal, masked before the exp
    y = torch.empty(bh, nc, L, p)
    for q0 in range(0, L, T):
        rows = torch.arange(q0, min(q0 + T, L))
        cq = C[..., q0:q0 + T, :]
        acc = torch.exp(seg[..., q0:q0 + T, None]) * mm(cq, prev, passes)
        for k0 in range(0, q0 + 1, T):
            keys = torch.arange(k0, min(k0 + T, L))
            sc = mm(cq, B[..., k0:k0 + T, :].transpose(-1, -2), passes)
            keep = keys[None, :] <= rows[:, None]
            diff = (seg[..., q0:q0 + T, None]
                    - seg[..., None, k0:k0 + T]).masked_fill(~keep, -np.inf)
            acc = acc + mm(sc * torch.exp(diff), x[..., k0:k0 + T, :],
                           passes)
        y[..., q0:q0 + T, :] = acc
    return y.reshape(bh, s, p), state


def _inputs(bh, s, p, n, hpg, seed):
    rs = np.random.default_rng(seed)
    xdt = 0.5 * rs.standard_normal((bh, s, p))
    B = 0.5 * rs.standard_normal((bh // hpg, s, n))
    C = 0.5 * rs.standard_normal((bh // hpg, s, n))
    dA = -np.log1p(np.exp(rs.standard_normal((bh, s))))
    init = rs.standard_normal((bh, n, p))
    return [torch.tensor(a, dtype=torch.float32)
            for a in (xdt, B, C, dA, init)]


def _worst(got, want):
    """max |got - want| / (atol + rtol |want|): <= 1 within SSD_TOL."""
    lim = SSD_TOL["atol"] + SSD_TOL["rtol"] * want.abs()
    return float(((got - want).abs() / lim).max())


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("bh,s,p,n,chunk,hpg", SHAPES)
def test_emulation_matches_ssd_scan_plain(bh, s, p, n, chunk, hpg,
                                          with_init):
    xdt, B, C, dA, init = _inputs(bh, s, p, n, hpg, s + p)
    init = init if with_init else None
    y, state = emulate(xdt, B, C, dA, chunk, hpg, init)
    want_y, want_state = ssd_scan_plain(xdt, B, C, dA, chunk, hpg, init)
    torch.testing.assert_close(y, want_y, **SSD_TOL)
    torch.testing.assert_close(state, want_state, **SSD_TOL)


@pytest.mark.parametrize("bh,s,p,n,chunk,hpg", SHAPES)
def test_emulation_matches_pallas(bh, s, p, n, chunk, hpg):
    """y against the reference's kernel, which takes B and C per head and
    starts from a zero state."""
    ref = load_reference()
    xdt, B, C, dA, _ = _inputs(bh, s, p, n, hpg, s + p)
    want = ref.ssd_scan.ssd_scan_pallas(
        jnp.asarray(xdt.numpy()),
        *(jnp.asarray(np.repeat(t.numpy(), hpg, 0)) for t in (B, C)),
        jnp.asarray(dA.numpy()), chunk=chunk, interpret=True)
    y, _ = emulate(xdt, B, C, dA, chunk, hpg)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **SSD_TOL)


def test_single_pass_tf32_misses_the_tolerance():
    """At the serve shape one TF32 product per operand pair is many times
    outside the tolerance that 3xTF32 meets with room."""
    bh, s, p, n, chunk, hpg = SERVE
    xdt, B, C, dA, _ = _inputs(bh, s, p, n, hpg, s + p)
    want_y, want_state = ssd_scan_plain(xdt, B, C, dA, chunk, hpg)
    one = emulate(xdt, B, C, dA, chunk, hpg, passes=1)
    three = emulate(xdt, B, C, dA, chunk, hpg, passes=3)
    assert _worst(one[0], want_y) > 5.0
    assert _worst(three[0], want_y) < 0.2
    assert _worst(three[1], want_state) < 0.2
