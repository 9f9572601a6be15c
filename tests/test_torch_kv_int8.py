"""The port's int8 KV cache (``kv_quant``) against the reference, on the
CPU: the quantize/dequantize pair, the cache layouts (dense, hybrid,
audio, MLA), one GQA layer's int8 prefill and decode, prefill then
decode through the steps (linear and ring caches, the hybrid's shared
attention), and the reference's own bound against the full forward.

Configs: qwen2-0.5b's smoke preset with ``kv_quant=True`` (float32, 2
layers, 4 query heads over 2 KV heads of 32) and zamba2-2.7b's.  On the
same inputs the int8 values equal the reference's (``torch.round`` and
``jnp.round`` both round half to even) and the scales are within one
float32 ulp.  Where the inputs are the layer's own k and v, which the
two compute in another summation order, an int8 value may sit on the
other side of a rounding boundary: it is then off by one, and only
where the unrounded value is within 1e-3 of a half.  Logits
within 1e-4, the reference's decode bound rel < 0.05
(tests/test_models.py's int8 case).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs, rng
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention, kvcache, transformer
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401

SMOKE = "qwen2-0.5b-smoke"
ATOL = 1e-4
F32_ATOL = 1e-5
ULP = 2.0 ** -23   # one float32 ulp at 1


def _cfg(name=SMOKE, **kw):
    return dataclasses.replace(configs.get_config(name), kv_quant=True, **kw)


def _ref_cfg(cfg):
    return load_reference().configs.ArchConfig(**dataclasses.asdict(cfg))


def _ref_params(cfg, seed=0):
    return jax.tree.map(np.asarray, load_reference().transformer.init_params(
        _ref_cfg(cfg), jax.random.PRNGKey(seed)))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _scales_close(got, want):
    """float32 scales within one ulp of their own size."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=ULP, atol=0)


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(dtype):
    """Random values, a row of exact halves (ties round to even: 0.5 ->
    0, 1.5 -> 2, -2.5 -> -2), a zero row (the 1e-8 floor): int8 values
    equal, scales within one ulp, dequantized values within one ulp of
    their dtype."""
    ref = load_reference()
    rs = np.random.default_rng(0)
    x = (3.0 * rs.standard_normal((2, 5, 3, 32))).astype(np.float32)
    x[0, 0, 0] = 0.0
    # amax 127 makes the scale 1: x / scale is x itself
    x[0, 1, 0] = np.resize([0.5, 1.5, -2.5, 126.5, -0.5, 2.5, 127.0, 3.5],
                           32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    xt = torch.tensor(x).to(tdt)
    xj = jnp.asarray(x, jdt)
    qj, sj = ref.attention._quantize_kv(xj)
    qt, st = attention._quantize_kv(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert tuple(st.shape) == (2, 5, 3)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    _scales_close(st.numpy(), sj)
    assert float(st[0, 1, 0]) == 1.0
    np.testing.assert_array_equal(
        qt[0, 1, 0, :8].numpy(), [0, 2, -2, 126, 0, 2, 127, 4])
    np.testing.assert_array_equal(qt[0, 0, 0].numpy(), 0)
    got = attention._dequantize_kv(qt, st, tdt)
    want = np.asarray(ref.attention._dequantize_kv(qj, sj, jdt), np.float32)
    assert got.dtype == tdt
    ulp = 2.0 ** -23 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=ulp,
                               atol=1e-30)


# ---------------------------------------------------------------------------
# the cache layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen2-0.5b", SMOKE, "zamba2-2.7b",
                                  "zamba2-2.7b-smoke", "whisper-medium",
                                  "deepseek-v2-236b-smoke"])
def test_cache_shapes_match_reference(name):
    """int8 ``k``/``v`` and float32 ``k_scale``/``v_scale`` of
    (..., B, Sc, Hkv): the dense cache, the hybrid's attention part (its
    mamba part unchanged), whisper's self-attention cache beside its cross
    K/V in the parameters' dtype; MLA's latent cache is not quantized, as
    in the reference."""
    ref = load_reference()
    cfg = _cfg(name)
    want = ref.kvcache.cache_shapes(_ref_cfg(cfg), 4, 1056)
    got = kvcache.cache_shapes(cfg, 4, 1056)
    assert set(got) == set(want)
    for group in got:
        if group == "pos":
            continue
        assert set(got[group]) == set(want[group]), group
        for k, (shape, dtype) in got[group].items():
            assert shape == want[group][k][0], (group, k)
            assert str(dtype).removeprefix("torch.") == \
                jnp.dtype(want[group][k][1]).name, (group, k)
    kv = got["attn"] if "attn" in got else got["layers"]
    if "k" in kv:
        assert kv["k"][1] == torch.int8
        assert kv["k_scale"] == (kv["k"][0][:-1], torch.float32)
    if name == "qwen2-0.5b":
        assert got["layers"]["k"][0] == (24, 4, 1056, 2, 64)
        assert got["layers"]["k_scale"][0] == (24, 4, 1056, 2)


def test_int8_cache_holds_half_the_bf16_bytes_and_more():
    """qwen2-0.5b at batch 4 and 1056 positions: 1 byte a k/v element
    and a 4-byte scale every 64, against 2 bytes a bf16 element."""
    def nbytes(cfg):
        cache = kvcache.init_cache(cfg, 4, 1056, device="meta")
        return sum(t.numel() * t.element_size()
                   for t in cache["layers"].values())

    full = configs.get_config("qwen2-0.5b")
    bf16, int8 = nbytes(full), nbytes(_cfg("qwen2-0.5b"))
    assert bf16 == 2 * 24 * 4 * 1056 * 2 * 64 * 2
    assert int8 == bf16 // 2 + 2 * 24 * 4 * 1056 * 2 * 4
    assert int8 / bf16 == pytest.approx(0.5 + 4 / 128)


# ---------------------------------------------------------------------------
# one GQA layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,T,seq_len", [
    (None, 16, 24),   # linear cache with free slots
    (8, 13, 20),      # ring cache shorter than the prompt
])
def test_gqa_int8_prefill_then_decode_matches_reference(monkeypatch, window,
                                                        T, seq_len, dtype):
    """The prompt (attention on the unquantized k/v, then the quantized
    tail into the cache) and three decode steps (this token's int8 k/v
    and scales into their slots, attention to the whole cache
    dequantized): the outputs within 1e-5 in float32 and 2 bf16 ulps of
    their scale in bf16; the scales within 1e-5 (float32; 1 bf16 ulp of
    k in bf16); the int8 values equal, but in float32 off by one where
    the port's own unrounded value (recorded around ``_quantize_kv``,
    laid out as the cache) is within 1e-3 of a half, and in bf16 off by
    one in under 2% of them (k and v round to bf16 before the scale)."""
    ref = load_reference()
    cfg = _cfg(sliding_window=window, param_dtype=dtype)
    rcfg = _ref_cfg(cfg)
    rs = np.random.default_rng(T)
    pj = jax.tree.map(np.asarray, ref.attention.init_attn(
        rcfg, jax.random.PRNGKey(T)))
    for b in ("bq", "bk", "bv"):
        pj[b] = (0.1 * rs.standard_normal(pj[b].shape)).astype(pj[b].dtype)
    pt = transformer.params_from_jax(None, pj, "cpu")
    pjj = jax.tree.map(jnp.asarray, pj)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    Sc = kvcache.cache_len(cfg, seq_len)
    shapes = kvcache.cache_shapes(dataclasses.replace(cfg, num_layers=1),
                                  2, seq_len)["layers"]
    ct = {k: torch.zeros(s[1:], dtype=d) for k, (s, d) in shapes.items()}
    cj = {k: jnp.asarray(v.numpy()) for k, v in ct.items()}
    unrounded = {k: np.zeros(ct[k].shape, np.float32) for k in ("k", "v")}
    seen = []
    real = attention._quantize_kv

    def recording(x):
        q, sc = real(x)
        seen.append((x.float() / sc[..., None]).numpy())
        return q, sc

    monkeypatch.setattr(attention, "_quantize_kv", recording)
    steps = [(np.arange(T), None)] + [
        (np.array([p]), kvcache.kv_positions(cfg, p, Sc, 2).numpy())
        for p in range(T, min(T + 3, seq_len))]
    for pos, kv_pos in steps:
        x = rs.standard_normal((2, len(pos), cfg.d_model)).astype(np.float32)
        q_pos = np.broadcast_to(pos, (2, len(pos))).astype(np.int32)
        kv_pos = q_pos if kv_pos is None else kv_pos
        oj, cj = ref.attention.gqa_attention(
            rcfg, pjj, jnp.asarray(x, jdt), jnp.asarray(q_pos),
            jnp.asarray(kv_pos), cj)
        seen.clear()
        with torch.no_grad():
            ot, ct = attention.gqa_attention(
                cfg, pt, torch.tensor(x).to(tdt), torch.tensor(q_pos),
                torch.tensor(kv_pos), ct)
        for k, u in zip(("k", "v"), seen):
            if len(pos) > 1:
                unrounded[k] = attention._tail_cache(torch.tensor(u),
                                                     Sc).numpy()
            else:
                slot = pos[0] % Sc if window is not None else pos[0]
                unrounded[k][:, slot] = u[:, 0]
        oj = np.asarray(oj, np.float32)
        atol = F32_ATOL if dtype == "float32" else \
            2 * 2.0 ** -8 * np.abs(oj).max()
        np.testing.assert_allclose(ot.float().numpy(), oj, rtol=0,
                                   atol=atol)
        for k in ("k", "v"):
            np.testing.assert_allclose(
                ct[k + "_scale"].numpy(), np.asarray(cj[k + "_scale"]),
                rtol=1e-5 if dtype == "float32" else 2.0 ** -8, atol=0)
            got = ct[k].numpy().astype(np.int32)
            want = np.asarray(cj[k], np.int32)
            assert np.abs(got - want).max() <= 1
            if dtype == "float32":
                u = unrounded[k][got != want]
                assert (np.abs(np.abs(u) % 1.0 - 0.5) < 1e-3).all(), u
            else:
                assert (got != want).mean() < 0.02


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _run_steps(cfg, prompt, total, seed):
    """The reference's jitted prefill and greedy decode steps and the
    port's on the same weights: tokens equal, last-token logits within
    1e-4; returns both final caches."""
    ref = load_reference()
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=seed)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    toks = _tokens(cfg, (2, prompt), seed)
    lj, cj = jax.jit(ref.steps.make_prefill_step(rcfg, total))(
        pj, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, ct = make_prefill_step(cfg, total)(pt, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=ATOL)
    nj = jnp.argmax(lj, -1).astype(jnp.int32)
    nt = torch.argmax(lt, -1)
    dec_j = jax.jit(ref.steps.make_decode_step(rcfg))
    dec_t = make_decode_step(cfg)
    for _ in range(total - prompt):
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        nj, cj = dec_j(pj, {"tokens": nj[:, None], "cache": cj})
        nt, ct = dec_t(pt, {"tokens": nt[:, None], "cache": ct})
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert ct["pos"] == int(cj["pos"]) == total
    return ct, cj


@pytest.mark.parametrize("window", [None, 16])
def test_prefill_and_decode_steps_match_reference(window):
    """Prompt 40 (past the window of 16: a 16-slot int8 ring) and three
    greedy decode steps; the int8 cache differs from the reference's in
    at most a few values, by one, and its scales are close."""
    cfg = _cfg(sliding_window=window)
    ct, cj = _run_steps(cfg, 40, 43, 2)
    for k in ("k", "v"):
        got = ct["layers"][k].numpy().astype(np.int32)
        want = np.asarray(cj["layers"][k], np.int32)
        assert got.dtype == want.dtype and np.abs(got - want).max() <= 1
        assert (got != want).mean() < 1e-3
        np.testing.assert_allclose(ct["layers"][k + "_scale"].numpy(),
                                   np.asarray(cj["layers"][k + "_scale"]),
                                   rtol=1e-4, atol=0)


def test_hybrid_int8_steps_match_reference():
    """zamba2's shared attention block with an int8 cache in each
    super-block (prompt 40, three decode steps)."""
    ct, cj = _run_steps(_cfg("zamba2-2.7b-smoke"), 40, 43, 3)
    assert ct["attn"]["k"].dtype == torch.int8


@pytest.mark.parametrize("how", ["token_by_token", "prefill_then_decode"])
def test_int8_decode_stays_within_the_reference_bound(how):
    """tests/test_models.py's int8 case: the logits of decoding 16
    tokens against an int8 cache (one at a time from an empty cache, or
    a prefill of 12 and 4 decode steps) within rel 0.05 of the exact
    forward; the reference's own such logits within 1e-4."""
    ref = load_reference()
    cfg = _cfg()
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    B, S = 2, 16
    toks = _tokens(cfg, (B, S), 1)
    full = np.asarray(ref.transformer.forward(
        rcfg, pj, {"tokens": jnp.asarray(toks)})[0])
    cache = kvcache.init_cache(cfg, B, S, device="cpu")
    cj = ref.kvcache.init_cache(rcfg, B, S)
    assert cache["layers"]["k"].dtype == torch.int8
    cuts = range(S + 1) if how == "token_by_token" else [0, 12, 13, 14, 15,
                                                         16]
    outs, outs_j = [], []
    fwd_j = jax.jit(lambda p, b, c: ref.transformer.forward(rcfg, p, b, c))
    for a, b in zip(cuts, list(cuts)[1:]):
        lg, _, cache = transformer.forward(
            cfg, pt, {"tokens": torch.tensor(toks[:, a:b])}, cache=cache)
        lj, _, cj = fwd_j(pj, {"tokens": jnp.asarray(toks[:, a:b])}, cj)
        outs.append(lg.numpy())
        outs_j.append(np.asarray(lj))
    inc = np.concatenate(outs, 1)
    rel = np.abs(full - inc).max() / max(np.abs(full).max(), 1e-9)
    assert rel < 0.05, rel
    np.testing.assert_allclose(inc, np.concatenate(outs_j, 1), rtol=0,
                               atol=ATOL)


def test_prefill_goes_through_the_kernel_module_unquantized(monkeypatch):
    """The int8 prefill calls flash attention once a layer on the
    unquantized k/v (floating, the parameters' dtype) at (B, T, H, hd);
    decode calls it never."""
    cfg = _cfg()
    seen = []
    flash = attention.flash_attention_heads

    def spy(q, k, v, window=None, k_shared=None):
        seen.append((tuple(q.shape), k.dtype, v.dtype, window))
        return flash(q, k, v, window, k_shared)

    monkeypatch.setattr(attention, "flash_attention_heads", spy)
    params = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    logits, cache = make_prefill_step(cfg, 44)(
        params, {"tokens": torch.zeros(2, 40, dtype=torch.long)})
    assert seen == [((2, 40, cfg.num_heads, 32), torch.float32,
                     torch.float32, None)] * 2
    make_decode_step(cfg)(params, {"tokens": torch.zeros(
        2, 1, dtype=torch.long), "cache": cache})
    assert len(seen) == 2
