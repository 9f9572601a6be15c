"""The port's audio family (whisper-medium's decoder: cross-attention to a
stub encoder output, learned positions, LayerNorm, tanh-GELU) against
the reference, on the CPU: the config, init and the weight bridge,
``cross_attention`` and ``encode_cross_kv``, the cache with its ``xk`` /
``xv``, prefill then decode (with ``enc_out`` in every step, and with
the cached cross K/V), the steps, serve, the no-cache forward, one
train step and the favg step.

Config: the smoke preset (float32, 2 layers, 4 query heads over 2 KV
heads of 32, d_model 256, 24 encoder frames).  Weights are the
reference's ``init_params`` tree carried across by ``params_from_jax``
(and, for the init itself, drawn by both from the same key); tokens and
encoder outputs are drawn from a seed with numpy.  Tolerances: logits
and cache leaves within 1e-4 (float32 on both sides, another summation
order), a cross-attention within 1e-5 in float32 and 2 bf16 ulps of the
output's scale in bf16, one SGD step within 1e-5, init within 4 float32
ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs, rng
from repro_torch.launch import serve as port_serve
from repro_torch.launch import steps
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention, kvcache, transformer
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401

ARCH = "whisper-medium"
ATOL = 1e-4
F32_ATOL = 1e-5


def _cfg(**kw):
    return dataclasses.replace(configs.get_config(ARCH + "-smoke"), **kw)


def _ref_cfg(cfg):
    return load_reference().configs.ArchConfig(**dataclasses.asdict(cfg))


def _ref_params(cfg, seed=0):
    return jax.tree.map(np.asarray, load_reference().transformer.init_params(
        _ref_cfg(cfg), jax.random.PRNGKey(seed)))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _batch(cfg, B, T, seed):
    """Tokens and an encoder output (normal x 0.1, as the reference's
    tests make it), numpy."""
    rs = np.random.default_rng(seed)
    return {"tokens": rs.integers(0, cfg.vocab_size, (B, T)),
            "enc_out": (0.1 * rs.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.tensor(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# the config, init and the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_match_reference(smoke):
    ref = load_reference()
    assert ARCH in configs.list_archs()
    name = ARCH + ("-smoke" if smoke else "")
    mine, theirs = configs.get_config(name), ref.configs.get_config(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.family == "audio" and mine.cross_attention
    assert mine.encoder_seq == (24 if smoke else 1500)


def test_init_params_match_reference():
    """The cross-attention weights (``xwq``..``xwo`` from keys 4-7 of the
    attention's split), ``ln_x``, LayerNorm biases and the learned
    position table: every leaf within 4 float32 ulps."""
    ref = load_reference()
    cfg = _cfg()
    want = _ref_params(cfg)
    got = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    assert set(got["blocks"]) == {"ln1", "ln2", "attn", "mlp", "ln_x"}
    assert list(got["blocks"])[-1] == "ln_x"   # the reference's order
    assert {"xwq", "xwk", "xwv", "xwo"} <= set(got["blocks"]["attn"])
    assert set(got["blocks"]["ln_x"]) == {"scale", "bias"}
    assert tuple(got["pos_embed"].shape) == (cfg.max_position, cfg.d_model)
    assert transformer.count_params(got) == \
        ref.transformer.count_params(want)
    for path, w in _leaves(want):
        g = _get(got, path)
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, rtol=4 * 2.0 ** -23,
                                   atol=1e-30, err_msg=str(path))


def test_params_from_jax_gives_the_same_forward():
    cfg = _cfg()
    _, batch = _both(_batch(cfg, 2, 40, 3))
    outs = [make_prefill_step(cfg, 44)(params, batch)[0]
            for params in (transformer.init_params(cfg, rng.PRNGKey(0),
                                                   device="cpu"),
                           transformer.params_from_jax(cfg, _ref_params(cfg),
                                                       device="cpu"))]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("smoke", [False, True])
def test_param_counts_match_reference(smoke):
    """At full width (the reference's shapes, ``jax.eval_shape``):
    1,582,764,032 parameters, 1,073,741,824 of them the 2**20 x 1024
    learned position table; active = all (no experts)."""
    ref = load_reference().transformer
    cfg = configs.get_config(ARCH + ("-smoke" if smoke else ""))
    shapes = jax.eval_shape(lambda: ref.init_params(
        _ref_cfg(cfg), jax.random.PRNGKey(0)))
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        shapes)
    n = transformer.count_params(meta)
    assert n == ref.count_params(shapes) == \
        transformer.active_params(cfg, meta)
    if not smoke:
        assert n == 1582764032
        assert meta["pos_embed"].numel() == (1 << 20) * 1024


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 24], ids=["decode", "prompt"])
def test_cross_attention_matches_reference(T, dtype):
    """``encode_cross_kv`` over 24 frames and ``cross_attention`` of T
    queries (every frame visible to every query): float32 within 1e-5,
    bf16 within 2 bf16 ulps of the output's scale."""
    ref = load_reference()
    cfg = _cfg(param_dtype=dtype)
    rcfg = _ref_cfg(cfg)
    pj = jax.tree.map(np.asarray, ref.attention.init_attn(
        rcfg, jax.random.PRNGKey(6)))
    pt = transformer.params_from_jax(None, pj, "cpu")
    rs = np.random.default_rng(6)
    x = rs.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    enc = rs.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    pjj = jax.tree.map(jnp.asarray, pj)
    ekv_j = ref.attention.encode_cross_kv(rcfg, pjj, jnp.asarray(enc, jdt))
    oj = ref.attention.cross_attention(rcfg, pjj, jnp.asarray(x, jdt), ekv_j)
    ekv_t = attention.encode_cross_kv(cfg, pt, torch.tensor(enc).to(tdt))
    ot = attention.cross_attention(cfg, pt, torch.tensor(x).to(tdt), ekv_t)
    assert ot.dtype == tdt
    for got, want in ((ekv_t["k"], ekv_j["k"]), (ekv_t["v"], ekv_j["v"]),
                      (ot, oj)):
        want = np.asarray(want, np.float32)
        atol = F32_ATOL if dtype == "float32" else \
            2 * 2.0 ** -8 * np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=atol)


def test_cross_attention_is_not_causal():
    """Query 0 reads the last frame: changing it changes query 0's
    output."""
    cfg = _cfg()
    p = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    p = {k: t[0] for k, t in p["blocks"]["attn"].items()}
    enc = torch.randn(1, cfg.encoder_seq, cfg.d_model)
    x = torch.randn(1, 1, cfg.d_model)
    a = attention.cross_attention(cfg, p, x,
                                  attention.encode_cross_kv(cfg, p, enc))
    enc[:, -1] += 1.0
    b = attention.cross_attention(cfg, p, x,
                                  attention.encode_cross_kv(cfg, p, enc))
    assert (a - b).abs().max() > 1e-3


def test_encoder_output_must_be_in_the_parameters_dtype():
    cfg = _cfg(param_dtype="bfloat16")
    p = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    p = {k: t[0] for k, t in p["blocks"]["attn"].items()}
    with pytest.raises(ValueError, match="cast it first"):
        attention.encode_cross_kv(cfg, p, torch.zeros(1, 3, cfg.d_model))


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [ARCH, ARCH + "-smoke"])
def test_cache_shapes_match_reference(name):
    """The dense cache plus the cross K/V, ``xk``/``xv`` (L, B, Senc,
    Hkv, hd) in the parameters' dtype (tests/test_steps.py's whisper
    case, batch 2, 64 positions): (24, 2, 1500, 16, 64) at full width."""
    ref = load_reference()
    cfg = configs.get_config(name)
    want = ref.kvcache.cache_shapes(_ref_cfg(cfg), 2, 64)
    got = kvcache.cache_shapes(cfg, 2, 64)
    assert set(got) == set(want) == {"pos", "layers"}
    assert set(got["layers"]) == set(want["layers"]) == {"k", "v", "xk",
                                                         "xv"}
    for k, (shape, dtype) in got["layers"].items():
        assert shape == want["layers"][k][0], k
        assert str(dtype).removeprefix("torch.") == \
            jnp.dtype(want["layers"][k][1]).name
    cache = kvcache.init_cache(cfg, 2, 64, device="meta")
    assert tuple(cache["layers"]["xk"].shape) == got["layers"]["xk"][0]
    if name == ARCH:
        assert got["layers"]["xk"][0] == (24, 2, 1500, 16, 64)
        assert got["layers"]["k"][0] == (24, 2, 64, 16, 64)


# ---------------------------------------------------------------------------
# prefill, decode, serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decode_enc", [True, False],
                         ids=["enc_out", "cached"])
def test_prefill_then_decode_matches_reference(decode_enc):
    """B 1, S 160: the prefill (with ``enc_out``) and one decode step,
    given ``enc_out`` again (the serve's way) or reading the cached cross
    K/V; against the reference's full forward over 161 (relative 5e-3)
    and its own prefill and decode: logits and every cache leaf within
    1e-4."""
    ref = load_reference()
    cfg = _cfg()
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=1)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    S = 160
    b = _batch(cfg, 1, S + 1, 1)
    full = np.asarray(ref.transformer.forward(
        rcfg, pj, {k: jnp.asarray(v) for k, v in b.items()})[0])
    scale = np.abs(full).max()
    cache = kvcache.init_cache(cfg, 1, S + 1, device="cpu")
    cj = ref.kvcache.init_cache(rcfg, 1, S + 1)
    for sl in (slice(0, S), slice(S, S + 1)):
        step = {"tokens": b["tokens"][:, sl]}
        if sl.start == 0 or decode_enc:
            step["enc_out"] = b["enc_out"]
        sj, st = _both(step)
        got, _, cache = transformer.forward(cfg, pt, st, cache=cache)
        want, _, cj = ref.transformer.forward(rcfg, pj, sj, cache=cj)
        assert np.abs(got.numpy() - full[:, sl]).max() / scale < 5e-3
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    assert cache["pos"] == int(cj["pos"]) == S + 1
    for k in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(cache["layers"][k].numpy(),
                                   np.asarray(cj["layers"][k]), rtol=0,
                                   atol=ATOL, err_msg=k)


def test_prefill_without_the_encoder_output_raises():
    cfg = _cfg()
    params = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    with pytest.raises(ValueError, match="enc_out"):
        make_prefill_step(cfg, 8)(params, {"tokens": torch.zeros(
            1, 4, dtype=torch.long)})


def test_prefill_and_decode_steps_match_reference():
    """The reference's jitted prefill (prompt 40 into 43 slots, with
    ``enc_out``) and three greedy decode steps with ``enc_out`` each:
    last-token logits within 1e-4, tokens equal, caches close."""
    ref = load_reference()
    cfg = _cfg()
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=2)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    prompt, total = 40, 43
    bj, bt = _both(_batch(cfg, 2, prompt, 2))
    lj, cj = jax.jit(ref.steps.make_prefill_step(rcfg, total))(pj, bj)
    lt, ct = make_prefill_step(cfg, total)(pt, bt)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=ATOL)
    nj = jnp.argmax(lj, -1).astype(jnp.int32)
    nt = torch.argmax(lt, -1)
    dec_j = jax.jit(ref.steps.make_decode_step(rcfg))
    dec_t = make_decode_step(cfg)
    for _ in range(total - prompt):
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        nj, cj = dec_j(pj, {"tokens": nj[:, None], "cache": cj,
                            "enc_out": bj["enc_out"]})
        nt, ct = dec_t(pt, {"tokens": nt[:, None], "cache": ct,
                            "enc_out": bt["enc_out"]})
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert ct["pos"] == int(cj["pos"]) == total
    for k in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(ct["layers"][k].numpy(),
                                   np.asarray(cj["layers"][k]), rtol=0,
                                   atol=ATOL, err_msg=k)


def test_serve_gives_the_reference_tokens():
    """``serve`` with the stub encoder output from PRNGKey(2), passed to
    the prefill and every decode step."""
    ref = load_reference()
    ref_lines, lines = [], []
    want = ref.serve.serve(ARCH, 2, 40, 6, smoke=True, log=ref_lines.append)
    got = port_serve.serve(ARCH, 2, 40, 6, smoke=True, log=lines.append,
                           device="cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lines[0] == ref_lines[0]


def test_prefill_goes_through_the_kernel_module(monkeypatch):
    """The prefill calls flash attention once a layer, for the causal
    self-attention at (B, T, H, hd); cross-attention calls it never."""
    cfg = _cfg()
    seen = []
    flash = attention.flash_attention_heads

    def spy(q, k, v, window=None, k_shared=None):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                     window))
        return flash(q, k, v, window, k_shared)

    monkeypatch.setattr(attention, "flash_attention_heads", spy)
    params = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    _, batch = _both(_batch(cfg, 2, 40, 0))
    make_prefill_step(cfg, 44)(params, batch)
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    assert seen == [((2, 40, H, 32), (2, 40, Hkv, 32), (2, 40, Hkv, 32),
                     None)] * 2


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_no_cache_forward_matches_reference(grad):
    """The training forward with ``enc_out``: without a gradient through
    flash attention's plain version, with one through
    ``masked_attention``; logits within 1e-4."""
    ref = load_reference()
    cfg = _cfg()
    pj = _ref_params(cfg, seed=7)
    p = transformer.params_from_jax(cfg, pj, "cpu")
    bj, bt = _both(_batch(cfg, 2, 64, 7))
    want, _, _ = ref.transformer.forward(_ref_cfg(cfg), pj, bj)
    with torch.set_grad_enabled(grad):
        if grad:
            p = steps.tree_map(lambda t: t.requires_grad_(True), p)
        got, _, cache = transformer.forward(cfg, p, bt)
    assert cache is None and got.requires_grad == grad
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


def test_train_step_matches_reference():
    """One SGD step on the KD loss with ``enc_out``, in two microbatches
    (grad_accum 2 splits ``enc_out`` with the tokens): loss, ce and kd
    within 1e-5, every updated parameter within 1e-5; the cross-attention
    weights move."""
    ref = load_reference()
    cfg = _cfg(grad_accum=2)
    pj = _ref_params(cfg, seed=0)
    p = transformer.params_from_jax(cfg, pj, "cpu")
    g = np.random.default_rng(2).random((cfg.fd_buckets, cfg.fd_buckets))
    batch = dict(_batch(cfg, 4, 64, 1),
                 gout=(g / g.sum(-1, keepdims=True)).astype(np.float32))
    bj, bt = _both(batch)
    want_p, want_m = jax.jit(ref.steps.make_train_step(_ref_cfg(cfg)))(pj, bj)
    got_p, got_m = steps.make_train_step(cfg)(p, bt)
    for k in ("loss", "ce", "kd"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=0, atol=F32_ATOL)
    for path, w in _leaves(jax.tree.map(np.asarray, want_p)):
        np.testing.assert_allclose(_get(got_p, path).numpy(), w, rtol=0,
                                   atol=F32_ATOL, err_msg=str(path))
    for name in ("xwq", "xwk", "xwv", "xwo"):
        moved = (got_p["blocks"]["attn"][name]
                 - p["blocks"]["attn"][name]).abs().max()
        assert float(moved) > 0, name


def test_favg_step_matches_reference():
    """The no-grad favg table with ``enc_out``: within 1e-5 of the
    reference's, its non-empty rows distributions."""
    ref = load_reference()
    cfg = _cfg()
    pj = _ref_params(cfg, seed=8)
    p = transformer.params_from_jax(cfg, pj, "cpu")
    bj, bt = _both(_batch(cfg, 4, 64, 8))
    want = jax.jit(ref.steps.make_favg_step(_ref_cfg(cfg)))(pj, bj)
    got = steps.make_favg_step(cfg)(p, bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)
    sums = got.sum(-1).numpy()
    np.testing.assert_allclose(sums[sums > 0], 1.0, atol=1e-4)
