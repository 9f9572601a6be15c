"""The port's hybrid family (zamba2-2.7b: Mamba2 layers in super-blocks,
each followed by one shared attention block) against the reference, on
the CPU: init and the weight bridge, the hybrid cache's layout, the
cache-building prefill and greedy decode, prefill then decode against
the no-cache forward, and the mixer's SSD at zamba2's head shape.

Two configs: the zamba2-2.7b smoke config (G = 1 super-block of A = 2
mamba layers, head dim 32, (P, N) = (32, 16), window 128) and a width-80
variant of it (G = 2 super-blocks sharing one attention block, head dim
80, (P, N) = (64, 64)), whose prefill reaches flash attention at d 80
and the SSD scan at (64, 64) through ``prefill_attention`` and
``ssd_chunked`` (their plain versions here, on the CPU).

Weights are the reference's own ``init_params`` tree carried across by
``params_from_jax`` (and, for the init itself, drawn by both from the
same key).  Tolerances: float32 on both sides in another summation
order, so logits and every cache leaf are held to 1e-4 (their entries
sum 256-wide products and a chunk's outer products); init within 4
float32 ulps; prefill then decode against the no-cache forward at the
reference's own relative 5e-3 (tests/test_models.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs, rng
from repro_torch.configs import zamba2_2_7b
from repro_torch.launch import serve as port_serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention, kvcache, mamba2, transformer
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401

ATOL = 1e-4
F32_TOL = dict(rtol=1e-5, atol=1e-5)
SMOKE = "zamba2-2.7b-smoke"
CASES = ["smoke", "width80"]


def _cfg(case="smoke", **kw):
    cfg = (zamba2_2_7b.width80_smoke() if case == "width80"
           else configs.get_config(SMOKE))
    return dataclasses.replace(cfg, **kw)


def _ref_cfg(cfg):
    return load_reference().configs.ArchConfig(**dataclasses.asdict(cfg))


def _ref_params(cfg, seed=0):
    ref = load_reference()
    return jax.tree.map(np.asarray, ref.transformer.init_params(
        _ref_cfg(cfg), jax.random.PRNGKey(seed)))


def _leaves(tree, prefix=()):
    """(path, leaf) of a nested dict, depth first, sorted keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


STATE = ("mamba", "state")


def _assert_cache_close(ct, cj, atol=ATOL, oracle=None):
    """Every leaf of the port's cache within ``atol`` of the reference's;
    with an ``oracle`` (the float64 run of :func:`_oracle_steps`), the
    mamba state's leaf instead holds each of the two within ``atol`` of
    the oracle's."""
    assert ct["pos"] == int(cj["pos"])
    assert set(ct) == set(cj) == {"pos", "mamba", "attn"}
    for path, t in _leaves({k: v for k, v in ct.items() if k != "pos"}):
        want = np.asarray(_get(cj, path))
        assert tuple(t.shape) == want.shape, path
        if oracle is not None and path == STATE:
            truth = _get(oracle, path).numpy()
            for side, got in (("port", t.numpy()), ("reference", want)):
                np.testing.assert_allclose(
                    got, truth, rtol=0, atol=atol,
                    err_msg=f"{path}: the {side} against float64")
            continue
        np.testing.assert_allclose(t.numpy(), want, rtol=0, atol=atol,
                                   err_msg=str(path))


def _oracle_steps(cfg, total, monkeypatch):
    """The port's prefill and decode steps with the mamba mixer computing
    in float64 between its projections and the mamba state kept in
    float64: the oracle the float32 states of both sides are held to."""
    f64 = functools.partial(mamba2.mamba2_forward, dtype=torch.float64)

    def f64_state(batch, seq_len, device=None):
        cache = kvcache.init_cache(cfg, batch, seq_len, device=device)
        return dict(cache, mamba=dict(cache["mamba"],
                                      state=cache["mamba"]["state"].double()))

    prefill = make_prefill_step(cfg, total, init_cache=f64_state)
    decode = make_decode_step(cfg)

    def run(step, *args):
        with monkeypatch.context() as m:
            m.setattr(transformer, "mamba2_forward", f64)
            return step(*args)

    return (functools.partial(run, prefill), functools.partial(run, decode))


# ---------------------------------------------------------------------------
# init and the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_init_params_hybrid_matches_reference(case):
    """The same key gives the same model, within 4 float32 ulps: the
    G * A mamba layers from one split of the layer key, reshaped to
    (G, A, ...), and the shared block from the next key."""
    ref = load_reference()
    cfg = _cfg(case)
    want = _ref_params(cfg)
    got = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    assert transformer.count_params(got) == \
        ref.transformer.count_params(want)
    assert set(got) == {"final_norm", "embed", "unembed", "blocks",
                        "shared_attn"}
    G, A = cfg.num_layers // cfg.attn_every, cfg.attn_every
    assert got["blocks"]["mamba"]["in_proj"].shape[:2] == (G, A)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = _get(got, [p.key for p in path])
        assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix(
            "torch.") == str(w.dtype), path
        np.testing.assert_allclose(g.numpy(), w, rtol=4 * 2.0 ** -23,
                                   atol=1e-30, err_msg=str(path))


def test_params_from_jax_hybrid_tree():
    """bf16 bits kept on every leaf of the hybrid tree, the (G, A)
    stacking as it is."""
    cfg = _cfg("width80", param_dtype="bfloat16")
    pj = _ref_params(cfg, seed=2)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    assert set(pt) == set(pj)
    for path, t in _leaves(pt):
        w = _get(pj, path)
        assert tuple(t.shape) == w.shape, path
        if w.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), w)


@pytest.mark.parametrize("case", CASES)
def test_params_from_jax_gives_the_same_forward(case):
    """The port's own init and the reference's tree carried across give
    the same prefill (the weights differ by at most 4 float32 ulps)."""
    cfg = _cfg(case)
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 40)))
    outs = []
    for params in (transformer.init_params(cfg, rng.PRNGKey(0),
                                           device="cpu"),
                   transformer.params_from_jax(cfg, _ref_params(cfg),
                                               device="cpu")):
        logits, cache = make_prefill_step(cfg, 44)(params, {"tokens": toks})
        outs.append((logits, cache))
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(),
                               rtol=0, atol=ATOL)
    for path, t in _leaves(outs[0][1]["mamba"]):
        np.testing.assert_allclose(t.numpy(),
                                   _get(outs[1][1]["mamba"], path).numpy(),
                                   rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the hybrid cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [SMOKE, "zamba2-2.7b", "width80"])
def test_hybrid_cache_matches_reference(name):
    """The reference's cache_shapes at batch 4 and 1056 positions (a
    1024 prompt and 32 tokens); at full width (9, 6, 4, 80, 64, 64)
    states and (9, 4, 1056, 32, 80) keys and values."""
    ref = load_reference()
    cfg = _cfg("width80") if name == "width80" else configs.get_config(name)
    want = ref.kvcache.cache_shapes(_ref_cfg(cfg), 4, 1056)
    got = kvcache.cache_shapes(cfg, 4, 1056)
    assert set(got) == set(want) == {"pos", "mamba", "attn"}
    for group, leaves in (("mamba", {"state", "conv"}),
                          ("attn", {"k", "v"})):
        assert set(got[group]) == set(want[group]) == leaves
        for k, (shape, dtype) in got[group].items():
            assert shape == want[group][k][0], (group, k)
            assert str(dtype).removeprefix("torch.") == \
                jnp.dtype(want[group][k][1]).name
    if name == "zamba2-2.7b":
        assert got["mamba"]["state"][0] == (9, 6, 4, 80, 64, 64)
        assert got["attn"]["k"][0] == (9, 4, 1056, 32, 80)
    if name == SMOKE:
        cache = kvcache.init_cache(cfg, 2, 8, device="cpu")
        assert cache["pos"] == 0
        for _, t in _leaves({k: v for k, v in cache.items() if k != "pos"}):
            assert not t.any()


def test_hybrid_cache_refuses_the_int8_cache():
    """The hybrid's int8 cache (refused until A15-arch part 3, hence the
    name): the reference's shapes and dtypes, int8 k/v and float32
    scales a (position, head) in the attention part, the mamba part
    unchanged."""
    ref = load_reference()
    cfg = _cfg(kv_quant=True)
    want = ref.kvcache.cache_shapes(_ref_cfg(cfg), 2, 8)
    got = kvcache.cache_shapes(cfg, 2, 8)
    assert set(got["attn"]) == set(want["attn"]) == {"k", "v", "k_scale",
                                                     "v_scale"}
    for group in ("mamba", "attn"):
        for k, (shape, dtype) in got[group].items():
            assert shape == want[group][k][0], (group, k)
            assert str(dtype).removeprefix("torch.") == \
                jnp.dtype(want[group][k][1]).name, (group, k)
    assert got["attn"]["k"][1] == torch.int8


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt", [40, 160])
@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_steps_match_reference(case, prompt,
                                                  monkeypatch):
    """Prompt 40 is no multiple of the smoke chunk (32): the SSD pads;
    160 passes the smoke window (128): the attention caches are rings.
    The prefill's last-token logits and every cache leaf, then three
    greedy decode steps (tokens equal, caches close).

    The mamba state (|x| up to ~22 at width 80) is held through a
    float64 oracle: the port and the reference each within ATOL of the
    port's steps with the mixer in float64.  Their float32 sums round
    the other way from the truth: at width 80 and prompt 160 the two
    sides lie 5.5e-5 and 5.7e-5 from it at the element where they are
    1.1e-4 apart."""
    ref = load_reference()
    cfg = _cfg(case)
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=prompt)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    total = prompt + 3
    toks = np.random.default_rng(prompt).integers(0, cfg.vocab_size,
                                                  (2, prompt))
    lj, cj = jax.jit(ref.steps.make_prefill_step(rcfg, total))(
        pj, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, ct = make_prefill_step(cfg, total)(pt, {"tokens": torch.tensor(toks)})
    pre_o, dec_o = _oracle_steps(cfg, total, monkeypatch)
    _, co = pre_o(pt, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=ATOL)
    _assert_cache_close(ct, cj, oracle=co)
    nj = jnp.argmax(lj, -1).astype(jnp.int32)
    nt = torch.argmax(lt, -1)
    dec_j = jax.jit(ref.steps.make_decode_step(rcfg))
    dec_t = make_decode_step(cfg)
    for _ in range(total - prompt):
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        _, co = dec_o(pt, {"tokens": nt[:, None], "cache": co})
        nj, cj = dec_j(pj, {"tokens": nj[:, None], "cache": cj})
        nt, ct = dec_t(pt, {"tokens": nt[:, None], "cache": ct})
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    _assert_cache_close(ct, cj, oracle=co)


@pytest.mark.parametrize("case", CASES)
def test_prefill_then_decode_continues_correctly(case):
    """The reference's test_prefill_then_decode_continues_correctly for
    zamba2 (tests/test_models.py, which cannot run under the installed
    jax, ROADMAP C1): a prefill of S = 160, past the smoke window, then
    one decode step, against the reference's no-cache forward over S + 1
    (its relative 5e-3) and against the reference's own prefill and
    decode with a cache (1e-4)."""
    ref = load_reference()
    cfg = _cfg(case)
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
    assert np.abs(pre.numpy() - full[:, :S]).max() / scale < 5e-3
    assert np.abs(dec.numpy()[:, 0] - full[:, S]).max() / scale < 5e-3
    cj = ref.kvcache.init_cache(rcfg, 1, S + 1)
    pre_j, _, cj = ref.transformer.forward(
        rcfg, pj, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)}, cache=cj)
    dec_j, _, cj = ref.transformer.forward(
        rcfg, pj, {"tokens": jnp.asarray(toks[:, S:], jnp.int32)}, cache=cj)
    np.testing.assert_allclose(pre.numpy(), np.asarray(pre_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_j), rtol=0,
                               atol=ATOL)
    _assert_cache_close(cache, cj)


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_full_forward(case):
    """The reference's test_decode_matches_full_forward for zamba2 (also
    unrunnable under the installed jax): every token decoded from an
    empty cache against the no-cache forward, at its relative 5e-3."""
    ref = load_reference()
    cfg = _cfg(case)
    pj = _ref_params(cfg)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    B, S = 2, 16
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    full, _, _ = ref.transformer.forward(
        _ref_cfg(cfg), pj, {"tokens": jnp.asarray(toks, jnp.int32)})
    full = np.asarray(full)
    cache = kvcache.init_cache(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, _, cache = transformer.forward(
            cfg, pt, {"tokens": torch.tensor(toks[:, t:t + 1])}, cache=cache)
        outs.append(lg[:, 0].numpy())
    inc = np.stack(outs, axis=1)
    assert np.abs(full - inc).max() / np.abs(full).max() < 5e-3


def test_serve_gives_the_reference_tokens():
    ref = load_reference()
    ref_lines, lines = [], []
    want = ref.serve.serve("zamba2-2.7b", 2, 40, 6, smoke=True,
                           log=ref_lines.append)
    got = port_serve.serve("zamba2-2.7b", 2, 40, 6, smoke=True,
                           log=lines.append, device="cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lines[0] == ref_lines[0] == \
        "arch=zamba2-2.7b params=1.97M batch=2 prompt=40 gen=6"
    assert lines[3] == ("sample continuation (seq 0): "
                        f"{got[0, :12].tolist()}")


def test_serve_takes_a_config(monkeypatch):
    """serve() given the width-80 variant as a config serves it as it
    is: the reference's serve, handed the same config through its
    registry, gives the same tokens and the same first log line."""
    ref = load_reference()
    cfg = _cfg("width80")
    monkeypatch.setattr(ref.serve, "get_config", lambda name: _ref_cfg(cfg))
    ref_lines, lines = [], []
    want = ref.serve.serve(cfg.name, 2, 40, 6, smoke=False,
                           log=ref_lines.append)
    got = port_serve.serve(cfg, 2, 40, 6, log=lines.append, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lines[0] == ref_lines[0]


# ---------------------------------------------------------------------------
# the kernel-holding modules at zamba2's head shapes
# ---------------------------------------------------------------------------

def test_width80_prefill_runs_through_the_kernel_modules(monkeypatch):
    """The width-80 variant's prefill calls flash attention once per
    super-block at d 80 (through ``prefill_attention``) and the SSD once
    per mamba layer at (P, N) = (64, 64) with all heads in one group
    (through ``ssd_chunked``), as zamba2's does at full width."""
    cfg = _cfg("width80")
    seen = {"flash": [], "ssd": []}
    flash, ssd = attention.flash_attention_heads, mamba2.ssd_chunked

    def spy_flash(q, k, v, window=None, k_shared=None):
        seen["flash"].append((tuple(q.shape), tuple(v.shape), window))
        return flash(q, k, v, window, k_shared)

    def spy_ssd(x, dt, A, Bm, Cm, chunk, initial_state=None):
        seen["ssd"].append((tuple(x.shape), tuple(Bm.shape), chunk))
        return ssd(x, dt, A, Bm, Cm, chunk, initial_state)

    monkeypatch.setattr(attention, "flash_attention_heads", spy_flash)
    monkeypatch.setattr(mamba2, "ssd_chunked", spy_ssd)
    params = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    toks = torch.zeros(2, 160, dtype=torch.long)
    make_prefill_step(cfg, 163)(params, {"tokens": toks})
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    assert seen["flash"] == [((2, 160, H, 80), (2, 160, Hkv, 80), 128)] * 2
    assert seen["ssd"] == [((2, 160, 8, 64), (2, 160, 1, 64), 32)] * 4


@pytest.mark.parametrize("route", ["plain", "scan"])
def test_ssd_chunked_at_the_zamba2_head_shape(route):
    """Both routes of ``ssd_chunked`` at (P, N) = (64, 64) with every head
    in one B/C group (zamba2's 80 heads; 8 here), from a given state,
    against the reference's."""
    ref = load_reference()
    B_, S, H, P, N, G = 2, 96, 8, 64, 64, 1
    rs = np.random.default_rng(80)
    x = (rs.standard_normal((B_, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal((B_, S, H)))).astype(np.float32)
    A = (-np.linspace(0.2, 1.0, H)).astype(np.float32)
    Bm = (rs.standard_normal((B_, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rs.standard_normal((B_, S, G, N)) * 0.5).astype(np.float32)
    init = rs.standard_normal((B_, H, N, P)).astype(np.float32)
    yj, fj = ref.mamba2.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=32,
        initial_state=jnp.asarray(init))
    fn = {"plain": mamba2.ssd_chunked, "scan": mamba2._ssd_chunked_scan}
    yt, ft = fn[route](*(torch.tensor(a) for a in (x, dt, A, Bm, Cm)), 32,
                       torch.tensor(init))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32_TOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **F32_TOL)
