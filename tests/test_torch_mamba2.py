"""The port's Mamba2 serve stack against the reference, on the CPU at
small sizes: the SSD scan's plain version (against ``ssd_scan_pallas``
in interpret mode, ``ref.ssd_ref`` and a float64 recurrence), the
model's ``ssd_chunked`` on both of its routes, the causal conv, the
mixer's prefill and decode, the SSM cache, init and the SSM forward.

Inputs are made from numpy seeds; weights are the reference's own
``init_params`` tree carried across by ``params_from_jax`` (and, for the
init itself, drawn by both from the same key).

Tolerances.  The SSD scan: atol 2e-4, rtol 1e-3, the reference's own for
its kernel (float32, another summation order and cumsum).  The model's
``ssd_chunked`` and the mixer: the same float32 einsums in another
summation order, 1e-5 absolute on O(1) values (the reference test
scales its inputs by 0.5) plus 1e-5 relative, for y and the states
whose entries sum a chunk's outer products and reach ~10.  Prefill then
decode against one longer prefill: the reference's relative 5e-3
(tests/test_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs, rng
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models import kvcache, mamba2, transformer
from test_torch_reference import load_reference

SSD_TOL = dict(atol=2e-4, rtol=1e-3)
F32_ATOL = 1e-5
F32_TOL = dict(rtol=1e-5, atol=F32_ATOL)
SMOKE = "mamba2-370m-smoke"


def _ref_cfg(cfg):
    return load_reference().configs.ArchConfig(**dataclasses.asdict(cfg))


def _ref_params(cfg, seed=0):
    ref = load_reference()
    return jax.tree.map(np.asarray, ref.transformer.init_params(
        _ref_cfg(cfg), jax.random.PRNGKey(seed)))


def _ssd_inputs(bh, s, p, n, seed, groups=None):
    rs = np.random.default_rng(seed)
    g = bh if groups is None else groups
    xdt = rs.standard_normal((bh, s, p)) * 0.5
    B = rs.standard_normal((g, s, n)) * 0.5
    C = rs.standard_normal((g, s, n)) * 0.5
    dA = -np.log1p(np.exp(rs.standard_normal((bh, s))))
    return [a.astype(np.float32) for a in (xdt, B, C, dA)]


def _recurrence(xdt, B, C, dA, init=None):
    """The SSD as its float64 recurrence: (y, final state)."""
    bh, s, p = xdt.shape
    state = (np.zeros((bh, B.shape[-1], p)) if init is None
             else np.asarray(init, np.float64))
    ys = []
    for t in range(s):
        state = np.exp(dA[:, t])[:, None, None] * state + \
            B[:, t, :, None] * xdt[:, t, None, :]
        ys.append(np.einsum("bn,bnp->bp", C[:, t], state))
    return np.stack(ys, 1), state


# ---------------------------------------------------------------------------
# the SSD scan (kernels/ssd_scan.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,s,p,n,chunk", [
    (2, 128, 32, 16, 32), (4, 256, 64, 32, 64), (1, 64, 16, 8, 16)])
def test_ssd_scan_plain_matches_pallas_and_ref(bh, s, p, n, chunk):
    ref = load_reference()
    xdt, B, C, dA = _ssd_inputs(bh, s, p, n, s + p)
    pallas = ref.ssd_scan.ssd_scan_pallas(
        *(jnp.asarray(a) for a in (xdt, B, C, dA)), chunk=chunk)
    seq = ref.ref.ssd_ref(*(jnp.asarray(a) for a in (xdt, B, C, dA)))
    y, state = ssd_scan_plain(*(torch.tensor(a) for a in (xdt, B, C, dA)),
                              chunk)
    assert y.dtype == torch.float32 and state.dtype == torch.float32
    assert tuple(state.shape) == (bh, n, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas), **SSD_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(seq), **SSD_TOL)
    want_y, want_state = _recurrence(xdt, B, C, dA)
    np.testing.assert_allclose(y.numpy(), want_y, **SSD_TOL)
    np.testing.assert_allclose(state.numpy(), want_state, **SSD_TOL)


def test_ssd_scan_plain_keeps_rows_apart():
    """The reference's test_ssd_kernel_state_isolated_between_batch_rows:
    the state starts at zero for every row."""
    ref = load_reference()
    xdt, B, C, dA = _ssd_inputs(3, 64, 8, 4, 7)
    t = [torch.tensor(a) for a in (xdt, B, C, dA)]
    full, fs = ssd_scan_plain(*t, 16)
    solo, ss = ssd_scan_plain(*(a[1:2] for a in t), 16)
    np.testing.assert_allclose(full[1].numpy(), solo[0].numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(fs[1].numpy(), ss[0].numpy(), rtol=0,
                               atol=1e-5)
    pallas = ref.ssd_scan.ssd_scan_pallas(
        *(jnp.asarray(a) for a in (xdt, B, C, dA)), chunk=16)
    np.testing.assert_allclose(full.numpy(), np.asarray(pallas), **SSD_TOL)


@pytest.mark.parametrize("hpg", [1, 4])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_scan_groups_and_initial_state(hpg, with_init):
    """heads_per_group: row bh reads B/C row bh // hpg; the final state
    and a given initial state against the recurrence."""
    bh, s, p, n = 8, 96, 16, 8
    xdt, B, C, dA = _ssd_inputs(bh, s, p, n, hpg, groups=bh // hpg)
    init = (np.random.default_rng(5).standard_normal((bh, n, p))
            .astype(np.float32) if with_init else None)
    kw = dict(heads_per_group=hpg)
    if with_init:
        kw["initial_state"] = torch.tensor(init)
    y, state = ssd_scan(*(torch.tensor(a) for a in (xdt, B, C, dA)), 32,
                        final=True, **kw)
    rep = [np.repeat(a, hpg, axis=0) for a in (B, C)]
    want_y, want_state = _recurrence(xdt, *rep, dA, init)
    np.testing.assert_allclose(y.numpy(), want_y, **SSD_TOL)
    np.testing.assert_allclose(state.numpy(), want_state, **SSD_TOL)
    y_only = ssd_scan(*(torch.tensor(a) for a in (xdt, B, C, dA)), 32, **kw)
    assert torch.equal(y_only, y)


# ---------------------------------------------------------------------------
# the mixer (models/mamba2.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["plain", "scan"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_reference(route, G, with_init):
    """Both routes of ssd_chunked on the CPU: the reference's einsums
    (``plain``, what CPU tensors take) and the kernel route's layout
    (``scan``: heads flattened into rows, groups through
    heads_per_group), here through the scan's plain version."""
    ref = load_reference()
    B_, S, H, P, N = 2, 96, 4, 16, 8
    rs = np.random.default_rng(6 + G)
    x = (rs.standard_normal((B_, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal((B_, S, H)))).astype(np.float32)
    A = (-np.ones(H) * 0.5).astype(np.float32)
    Bm = (rs.standard_normal((B_, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rs.standard_normal((B_, S, G, N)) * 0.5).astype(np.float32)
    init = (rs.standard_normal((B_, H, N, P)).astype(np.float32)
            if with_init else None)
    yj, fj = ref.mamba2.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=32,
        initial_state=None if init is None else jnp.asarray(init))
    fn = {"plain": mamba2.ssd_chunked, "scan": mamba2._ssd_chunked_scan}
    yt, ft = fn[route](*(torch.tensor(a) for a in (x, dt, A, Bm, Cm)), 32,
                       None if init is None else torch.tensor(init))
    assert tuple(yt.shape) == (B_, S, H, P)
    assert tuple(ft.shape) == (B_, H, N, P)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32_TOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **F32_TOL)


def test_causal_conv_matches_reference():
    ref = load_reference()
    rs = np.random.default_rng(8)
    x, w, b = (rs.standard_normal(s).astype(np.float32)
               for s in ((2, 10, 24), (4, 24), (24,)))
    want = ref.mamba2._causal_conv(*(jnp.asarray(a) for a in (x, w, b)))
    got = mamba2._causal_conv(*(torch.tensor(a) for a in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _mixer(seed=0):
    cfg = configs.get_config(SMOKE)
    pj = jax.tree.map(np.asarray, load_reference().mamba2.init_mamba(
        _ref_cfg(cfg), jax.random.PRNGKey(seed)))
    pt = {k: torch.tensor(v) for k, v in pj.items()}
    return cfg, pj, pt


@pytest.mark.parametrize("S", [64, 40])
def test_mamba2_forward_prefill_and_decode_match_reference(S):
    """S = 64: two whole chunks of 32; S = 40: padded with dt = 0 steps.
    Then one decode step from the prefill's cache."""
    ref = load_reference()
    cfg, pj, pt = _mixer(seed=S)
    rcfg = _ref_cfg(cfg)
    rs = np.random.default_rng(S)
    x = rs.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    x1 = rs.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    shapes = kvcache.cache_shapes(cfg, 2, S + 1)["layers"]
    cj = {k: jnp.zeros(s[1:], jnp.float32) for k, (s, _) in shapes.items()}
    ct = {k: torch.zeros(s[1:], dtype=d) for k, (s, d) in shapes.items()}
    # no cache: the mixer alone
    oj, _ = ref.mamba2.mamba2_forward(rcfg, pj, jnp.asarray(x))
    ot, none = mamba2.mamba2_forward(cfg, pt, torch.tensor(x))
    assert none is None
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                               atol=F32_ATOL)
    # prefill into the cache, then one token
    for inp in (x, x1):
        oj, cj = ref.mamba2.mamba2_forward(rcfg, pj, jnp.asarray(inp), cj)
        ot, ct2 = mamba2.mamba2_forward(cfg, pt, torch.tensor(inp), ct)
        assert ct2 is ct
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0,
                                   atol=F32_ATOL)
        for k in ("state", "conv"):
            assert tuple(ct[k].shape) == cj[k].shape
            np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]),
                                       **F32_TOL)


def test_prefill_shorter_than_the_conv_window_raises():
    cfg, _, pt = _mixer()
    shapes = kvcache.cache_shapes(cfg, 1, 4)["layers"]
    ct = {k: torch.zeros(s[1:], dtype=d) for k, (s, d) in shapes.items()}
    with pytest.raises(ValueError, match="conv cache"):
        mamba2.mamba2_forward(cfg, pt, torch.zeros(1, 2, cfg.d_model), ct)


# ---------------------------------------------------------------------------
# cache, init and the SSM forward (models/kvcache.py, models/transformer.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [SMOKE, "mamba2-370m"])
def test_ssm_cache_matches_reference(name):
    ref = load_reference()
    cfg = configs.get_config(name)
    want = ref.kvcache.cache_shapes(_ref_cfg(cfg), 4, 1056)
    got = kvcache.cache_shapes(cfg, 4, 1056)
    assert set(got["layers"]) == set(want["layers"]) == {"state", "conv"}
    for k, (shape, dtype) in got["layers"].items():
        assert shape == want["layers"][k][0]
        assert str(dtype).removeprefix("torch.") == \
            jnp.dtype(want["layers"][k][1]).name
    if name == SMOKE:
        cache = kvcache.init_cache(cfg, 2, 8, device="cpu")
        assert cache["pos"] == 0
        assert all(not t.any() for t in cache["layers"].values())


def test_init_params_mamba2_matches_reference():
    """The same key gives the same model, within 4 float32 ulps."""
    ref = load_reference()
    cfg = configs.get_config(SMOKE)
    want = _ref_params(cfg, seed=0)
    got = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    assert transformer.count_params(got) == \
        ref.transformer.count_params(want)
    assert set(got) == {"final_norm", "embed", "unembed", "blocks"}
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for p in path:
            g = g[p.key]
        assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix(
            "torch.") == str(w.dtype), path
        np.testing.assert_allclose(g.numpy(), w, rtol=4 * 2.0 ** -23,
                                   atol=1e-30, err_msg=str(path))


def test_params_from_jax_ssm_tree():
    cfg = dataclasses.replace(configs.get_config(SMOKE),
                              param_dtype="bfloat16", num_layers=1)
    pj = _ref_params(cfg, seed=2)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    m = pt["blocks"]["mamba"]
    assert m["in_proj"].dtype == torch.bfloat16
    assert m["A_log"].dtype == m["D"].dtype == m["dt_bias"].dtype == \
        torch.float32
    np.testing.assert_array_equal(
        m["in_proj"].view(torch.int16).numpy(),
        pj["blocks"]["mamba"]["in_proj"].view(np.int16))
    np.testing.assert_array_equal(m["D"].numpy(), pj["blocks"]["mamba"]["D"])


def test_prefill_then_decode_continues_correctly():
    """The reference's test_prefill_then_decode_continues_correctly for
    mamba2: a prefill of S = 160 (five whole chunks), then one decode
    step, against the reference's no-cache forward over S + 1 and the
    port's own prefill of S + 1 (padded to six chunks)."""
    ref = load_reference()
    cfg = configs.get_config(SMOKE)
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    S = 160
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, S + 1))
    full, _, _ = ref.transformer.forward(
        rcfg, pj, {"tokens": jnp.asarray(toks, jnp.int32)})
    full = np.asarray(full)
    scale = np.abs(full).max()
    cache = kvcache.init_cache(cfg, 1, S + 1, device="cpu")
    pre, _, cache = transformer.forward(
        cfg, pt, {"tokens": torch.tensor(toks[:, :S])}, cache=cache)
    dec, _, cache = transformer.forward(
        cfg, pt, {"tokens": torch.tensor(toks[:, S:])}, cache=cache)
    assert cache["pos"] == S + 1
    one, _, _ = transformer.forward(
        cfg, pt, {"tokens": torch.tensor(toks)},
        cache=kvcache.init_cache(cfg, 1, S + 1, device="cpu"))
    assert np.abs(pre.numpy() - full[:, :S]).max() / scale < 5e-3
    assert np.abs(dec.numpy()[:, 0] - full[:, S]).max() / scale < 5e-3
    assert np.abs(dec.numpy()[:, 0] - one.numpy()[:, S]).max() / scale \
        < 5e-3
