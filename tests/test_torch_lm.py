"""The port's LM serve stack against the reference, module by module, on
the CPU: configs, rope, norms, the KV cache, GQA attention (prefill and
decode), the prefill/decode steps and the token data.

Weights are the reference's own ``init_params`` tree carried across by
``params_from_jax`` (and, for the init itself, drawn by both from the
same key).  Inputs are made from numpy seeds.

Tolerances.  float32: both sides run the same float32 arithmetic in
another summation order (and XLA's vs PyTorch's exp/rsqrt/cos), so
values agree to ~1e-6 of their scale; 1e-5 absolute on O(1) activations
and 1e-4 on logits, whose rows sum 256-dim products.  bfloat16: PyTorch
and XLA round products and sums at other points, and the flash kernel
rounds the unnormalised probabilities where the reference rounds the
normalised ones, so bf16 values are held to a few bf16 ulps (stated at
each test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs, rng
from repro_torch.data import synthetic_tokens
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention, kvcache, layers, rope, transformer
from test_torch_reference import load_reference

F32_ATOL = 1e-5
LOGIT_ATOL = 1e-4
SMOKE = "qwen2-0.5b-smoke"


def _cfg(name=SMOKE, **kw):
    return dataclasses.replace(configs.get_config(name), **kw)


def _ref_cfg(cfg):
    """The reference's ArchConfig with the same fields."""
    return load_reference().configs.ArchConfig(**dataclasses.asdict(cfg))


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _t(a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _ref_params(cfg, seed=0):
    ref = load_reference()
    return jax.tree.map(np.asarray, ref.transformer.init_params(
        _ref_cfg(cfg), jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-370m", "zamba2-2.7b",
                                  "paper-cnn", "qwen3-14b", "phi3-mini-3.8b",
                                  "h2o-danube-3-4b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_arch_config_fields_match_reference(name, smoke):
    ref = load_reference()
    assert name in configs.list_archs()
    full = name + ("-smoke" if smoke else "")
    mine, theirs = configs.get_config(full), ref.configs.get_config(full)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for prop in ("v_head", "d_inner", "ssm_heads", "is_moe",
                 "subquadratic"):
        assert getattr(mine, prop) == getattr(theirs, prop), prop
    for shape in ref.configs.INPUT_SHAPES:
        assert mine.supports_shape(shape) == theirs.supports_shape(shape)
    assert {k: dataclasses.asdict(v) for k, v in
            configs.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in
        ref.configs.INPUT_SHAPES.items()}


# ---------------------------------------------------------------------------
# rope and norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,theta", [(32, 1e4), (64, 1e6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(head_dim, theta, dtype):
    ref = load_reference()
    rs = np.random.default_rng(head_dim)
    pos = rs.integers(0, 1100, (2, 9))
    x = rs.standard_normal((2, 9, 3, head_dim))
    cj, sj = ref.rope.rope_cos_sin(jnp.asarray(pos, jnp.int32), head_dim,
                                   theta)
    ct, st = rope.rope_cos_sin(torch.tensor(pos), head_dim, theta)
    # cos/sin of angles up to ~1100 rad: argument reduction differs
    np.testing.assert_allclose(_np(ct), np.asarray(cj), rtol=0, atol=2e-6)
    np.testing.assert_allclose(_np(st), np.asarray(sj), rtol=0, atol=2e-6)
    want = np.asarray(ref.rope.apply_rope(_jnp(x, getattr(jnp, dtype)), cj,
                                          sj), np.float32)
    got = rope.apply_rope(_t(x, dtype), ct, st)
    assert got.dtype == getattr(torch, dtype)
    # bf16: c and s round to bf16 on both sides; a last-bit difference
    # in cos/sin can flip one rounding: 2 bf16 ulps at |x| <= 4
    atol = F32_ATOL if dtype == "float32" else 2 * 2.0 ** -6
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm_matches_reference(norm_type, dtype):
    ref = load_reference()
    cfg = _cfg(norm_type=norm_type, param_dtype=dtype)
    rs = np.random.default_rng(5)
    x = 3.0 * rs.standard_normal((2, 7, cfg.d_model))
    scale = 1.0 + 0.1 * rs.standard_normal(cfg.d_model)
    bias = 0.1 * rs.standard_normal(cfg.d_model)
    pj = {"scale": _jnp(scale, getattr(jnp, dtype)),
          "bias": _jnp(bias, getattr(jnp, dtype))}
    pt = {"scale": _t(scale, dtype), "bias": _t(bias, dtype)}
    want = np.asarray(ref.layers.apply_norm(
        _ref_cfg(cfg), pj, _jnp(x, getattr(jnp, dtype))), np.float32)
    got = layers.apply_norm(cfg, pt, _t(x, dtype))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=F32_ATOL)
    else:
        # inv is cast to bf16 before the multiply on both sides, so the
        # result agrees to the last bf16 bit except where the f32 sum of
        # squares rounds across a bf16 boundary of inv: 1 bf16 ulp
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                  1e-30))) - 7)
        assert (np.abs(_np(got) - want) <= ulp).all()


def test_norm_init_and_activations_match_reference():
    ref = load_reference()
    cfg = _cfg(norm_type="layernorm")
    want = ref.layers.init_norm(_ref_cfg(cfg), 16)
    got = layers.init_norm(cfg, 16, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    x = np.linspace(-6, 6, 101).astype(np.float32)
    for name in ("silu", "gelu", "relu"):
        np.testing.assert_allclose(
            _np(layers.act_fn(name)(torch.tensor(x))),
            np.asarray(ref.layers.act_fn(name)(jnp.asarray(x))),
            rtol=0, atol=F32_ATOL)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 8])
def test_cache_and_kv_positions_match_reference(window):
    ref = load_reference()
    cfg = _cfg(sliding_window=window)
    rcfg = _ref_cfg(cfg)
    for seq_len in (5, 8, 20):
        want = ref.kvcache.init_cache(rcfg, 3, seq_len)
        got = kvcache.init_cache(cfg, 3, seq_len, device="cpu")
        assert got["pos"] == int(want["pos"]) == 0
        for k in ("k", "v"):
            assert tuple(got["layers"][k].shape) == \
                want["layers"][k].shape
            assert not got["layers"][k].any()
        Sc = kvcache.cache_len(cfg, seq_len)
        assert Sc == ref.kvcache.cache_len(rcfg, seq_len)
        for pos in (0, 3, 7, 8, 13, 19):
            np.testing.assert_array_equal(
                kvcache.kv_positions(cfg, pos, Sc, 3).numpy(),
                np.asarray(ref.kvcache.kv_positions(
                    rcfg, jnp.int32(pos), Sc, 3)))


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def _attn_case(cfg, T, seq_len, seed=0):
    """Reference attention params, an input, an empty cache for both."""
    ref = load_reference()
    rcfg = _ref_cfg(cfg)
    pj = jax.tree.map(np.asarray, ref.attention.init_attn(
        rcfg, jax.random.PRNGKey(seed)))
    rs = np.random.default_rng(seed)
    # non-zero biases, so the bias path is exercised
    for b in ("bq", "bk", "bv"):
        pj[b] = (0.1 * rs.standard_normal(pj[b].shape)).astype(
            pj[b].dtype)
    x = rs.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    Sc = kvcache.cache_len(cfg, seq_len)
    shape = (2, Sc, cfg.num_kv_heads, cfg.head_dim)
    return rcfg, pj, x, shape


@pytest.mark.parametrize("window,T,seq_len", [
    (None, 16, 24),   # linear cache with free slots (_tail_cache pads)
    (None, 16, 16),   # prompt fills the cache
    (8, 13, 20),      # ring cache shorter than the prompt (rolled tail)
])
def test_gqa_prefill_then_decode_matches_reference(window, T, seq_len):
    ref = load_reference()
    cfg = _cfg(sliding_window=window)
    rcfg, pj, x, shape = _attn_case(cfg, T, seq_len)
    pt = {k: torch.tensor(v) for k, v in pj.items()}
    q_pos = np.broadcast_to(np.arange(T), (2, T))
    cj = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    ct = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    oj, cj = ref.attention.gqa_attention(
        rcfg, pj, jnp.asarray(x), jnp.asarray(q_pos, jnp.int32),
        jnp.asarray(q_pos, jnp.int32), cj)
    ot, ct = attention.gqa_attention(cfg, pt, torch.tensor(x),
                                     torch.tensor(q_pos),
                                     torch.tensor(q_pos), ct)
    np.testing.assert_allclose(_np(ot), np.asarray(oj), rtol=0,
                               atol=F32_ATOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(ct[k]), np.asarray(cj[k]), rtol=0,
                                   atol=F32_ATOL)
    # up to three decode steps against the filled caches, while the
    # positions fit the sequence the cache was made for
    rs = np.random.default_rng(1)
    for pos in range(T, min(T + 3, seq_len)):
        xd = rs.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        qp = np.full((2, 1), pos)
        kv = kvcache.kv_positions(cfg, pos, shape[1], 2)
        oj, cj = ref.attention.gqa_attention(
            rcfg, pj, jnp.asarray(xd), jnp.asarray(qp, jnp.int32),
            jnp.asarray(kv.numpy()), cj)
        ot, ct = attention.gqa_attention(cfg, pt, torch.tensor(xd),
                                         torch.tensor(qp), kv, ct)
        np.testing.assert_allclose(_np(ot), np.asarray(oj), rtol=0,
                                   atol=F32_ATOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(ct[k]), np.asarray(cj[k]),
                                       rtol=0, atol=F32_ATOL)


def test_prefill_expands_kv_heads_by_repeat_interleave():
    """Query head h reads KV head h // G: four query heads over two KV
    heads, with each KV head's values constant and distinct."""
    B, T, d = 1, 5, 32
    q = torch.randn(B, T, 4, d, generator=torch.Generator().manual_seed(0))
    k = torch.zeros(B, T, 2, d)
    v = torch.stack([torch.full((B, T, d), 1.0),
                     torch.full((B, T, d), 2.0)], dim=2)
    o = attention.prefill_attention(q, k, v)
    np.testing.assert_allclose(_np(o[0, :, :, 0]),
                               [[1.0, 1.0, 2.0, 2.0]] * T)


# ---------------------------------------------------------------------------
# transformer, steps, data
# ---------------------------------------------------------------------------

def test_init_params_matches_reference():
    """The same key gives the same model: jax.random.normal through the
    port's threefry, within a few float32 ulps."""
    ref = load_reference()
    cfg = _cfg()
    want = _ref_params(cfg, seed=0)
    got = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert transformer.count_params(got) == \
        ref.transformer.count_params(want)
    for path, w in flat_w:
        g = got
        for p in path:
            g = g[p.key]
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(_np(g), w, rtol=4 * 2.0 ** -23,
                                   atol=1e-30, err_msg=str(path))


def test_params_from_jax_keeps_bfloat16_bits():
    cfg = _cfg(param_dtype="bfloat16", num_layers=1)
    pj = _ref_params(cfg, seed=2)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    assert pt["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pt["blocks"]["mlp"]["w2"].view(torch.int16).numpy(),
        pj["blocks"]["mlp"]["w2"].view(np.int16))


@pytest.mark.parametrize("window", [None, 16])
def test_prefill_and_decode_steps_match_reference(window):
    ref = load_reference()
    cfg = _cfg(sliding_window=window)
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=3)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    B, T, total = 2, 20, 24
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, T))
    # the whole (B, T, V) prefill logits through forward
    cj = ref.kvcache.init_cache(rcfg, B, total)
    lj, _, _ = ref.transformer.forward(rcfg, pj, {
        "tokens": jnp.asarray(toks, jnp.int32)}, cache=cj)
    lt, aux, _ = transformer.forward(cfg, pt, {"tokens": torch.tensor(toks)},
                                     cache=kvcache.init_cache(cfg, B, total,
                                                              "cpu"))
    assert tuple(lt.shape) == (B, T, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0,
                               atol=LOGIT_ATOL)
    # the steps: last logits, the filled cache, then greedy decode
    lj, cj = jax.jit(ref.steps.make_prefill_step(rcfg, total))(
        pj, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, ct = make_prefill_step(cfg, total)(pt, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0,
                               atol=LOGIT_ATOL)
    assert ct["pos"] == int(cj["pos"]) == T
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(ct["layers"][k]),
                                   np.asarray(cj["layers"][k]), rtol=0,
                                   atol=F32_ATOL)
    nj = jnp.argmax(lj, -1).astype(jnp.int32)
    nt = torch.argmax(lt, -1)
    dec_j = jax.jit(ref.steps.make_decode_step(rcfg))
    dec_t = make_decode_step(cfg)
    for _ in range(total - T):
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        nj, cj = dec_j(pj, {"tokens": nj[:, None], "cache": cj})
        nt, ct = dec_t(pt, {"tokens": nt[:, None], "cache": ct})
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert ct["pos"] == int(cj["pos"]) == total
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(ct["layers"][k]),
                                   np.asarray(cj["layers"][k]), rtol=0,
                                   atol=F32_ATOL)


@pytest.mark.parametrize("n,T,vocab", [(2, 64, 512), (3, 17, 151936),
                                       (1, 1, 7)])
def test_synthetic_tokens_bit_exact(n, T, vocab):
    ref = load_reference()
    want = ref.synthetic.synthetic_tokens(jax.random.PRNGKey(1), n, T,
                                          vocab)
    got = synthetic_tokens(rng.PRNGKey(1), n, T, vocab, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_without_a_cache_raises():
    """The no-cache forward runs since A15-train
    (tests/test_torch_train_steps.py).  Its name is older: the options
    it once refused run since A15-arch part 3, so it holds them to the
    reference: cross-attention without a cache (with ``enc_out``, and
    without it, where both fail), and M-RoPE's cos and sin."""
    ref = load_reference()
    cfg = _cfg(num_layers=1)
    params = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    logits, _, cache = transformer.forward(
        cfg, params, {"tokens": torch.zeros(1, 3, dtype=torch.long)})
    assert logits.shape == (1, 3, cfg.vocab_size) and cache is None
    xcfg = _cfg(num_layers=1, cross_attention=True, encoder_seq=5)
    pj = _ref_params(xcfg, seed=3)
    pt = transformer.params_from_jax(xcfg, pj, device="cpu")
    toks = np.zeros((1, 3), np.int64)
    enc = np.random.default_rng(3).standard_normal(
        (1, 5, xcfg.d_model)).astype(np.float32)
    got = transformer.forward(xcfg, pt, {"tokens": torch.tensor(toks),
                                         "enc_out": torch.tensor(enc)})[0]
    want = ref.transformer.forward(_ref_cfg(xcfg), pj,
                                   {"tokens": jnp.asarray(toks),
                                    "enc_out": jnp.asarray(enc)})[0]
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
    with pytest.raises(ValueError, match="enc_out"):
        transformer.forward(xcfg, pt, {"tokens": torch.tensor(toks)})
    with pytest.raises(AttributeError):
        ref.transformer.forward(_ref_cfg(xcfg), pj,
                                {"tokens": jnp.asarray(toks)})
    pos3 = np.random.default_rng(4).integers(0, 50, (1, 3, 3))
    for got, want in zip(rope.mrope_cos_sin(torch.tensor(pos3), 32, 1e4),
                         ref.rope.mrope_cos_sin(jnp.asarray(pos3), 32, 1e4)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=2.0 ** -23)
