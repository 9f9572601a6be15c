"""The port's dense GQA families against the reference, on the CPU:
qwen3-14b (qk-norm, GQA 40/8, head dim 128), phi3-mini-3.8b (MHA 32/32,
head dim 96) and h2o-danube-3-4b (GQA 32/8, head dim 120, a window of
4096).  Init and the weight bridge, the headwise qk-norm inside
``gqa_attention``, the caches (danube's a ring), the cache-building
prefill and greedy decode, serve, and one train step.

Configs: the three smoke configs (float32, 2 layers, head dim 32;
danube's window 128) and two width variants at the published head
shapes, ``configs/phi3_mini_3_8b.py::width96_smoke`` (4 heads of 96)
and ``configs/h2o_danube3_4b.py::width120_smoke`` (4 heads of 120 on
one KV head, window 128), whose prefill reaches flash attention at d 96
and d 120 through ``prefill_attention`` (its plain version here).

Weights are the reference's own ``init_params`` tree carried across by
``params_from_jax`` (and, for the init itself, drawn by both from the
same key); inputs are drawn from a seed with numpy.  Tolerances: logits
and cache leaves within 1e-4 (float32 on both sides in another
summation order), attention outputs within 1e-5 in float32 and 2 bf16
ulps in bf16, one SGD step within 1e-5, init within 4 float32 ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs, rng
from repro_torch.configs import h2o_danube3_4b, phi3_mini_3_8b
from repro_torch.launch import serve as port_serve
from repro_torch.launch import steps
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention, kvcache, transformer
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401

ATOL = 1e-4
F32_ATOL = 1e-5
ARCHS = ["qwen3-14b", "phi3-mini-3.8b", "h2o-danube-3-4b"]
CASES = ARCHS + ["width96", "width120"]


def _cfg(case, **kw):
    cfg = {"width96": phi3_mini_3_8b.width96_smoke,
           "width120": h2o_danube3_4b.width120_smoke}.get(
        case, lambda: configs.get_config(case + "-smoke"))()
    return dataclasses.replace(cfg, **kw)


def _ref_cfg(cfg):
    return load_reference().configs.ArchConfig(**dataclasses.asdict(cfg))


def _ref_params(cfg, seed=0):
    ref = load_reference()
    return jax.tree.map(np.asarray, ref.transformer.init_params(
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


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


# ---------------------------------------------------------------------------
# configs, init and the weight bridge
# ---------------------------------------------------------------------------

def test_width_variants_keep_the_published_head_shapes():
    phi3, danube = (configs.get_config(n) for n in ARCHS[1:])
    w96, w120 = _cfg("width96"), _cfg("width120")
    assert (w96.head_dim, w96.num_heads // w96.num_kv_heads) == (
        phi3.head_dim, phi3.num_heads // phi3.num_kv_heads) == (96, 1)
    assert (w120.head_dim, w120.num_heads // w120.num_kv_heads) == (
        danube.head_dim, danube.num_heads // danube.num_kv_heads) == (120, 4)
    assert w120.sliding_window == 128 and danube.sliding_window == 4096
    assert configs.get_config("qwen3-14b-smoke").qk_norm


@pytest.mark.parametrize("case", CASES)
def test_init_params_match_reference(case):
    """The same key gives the same model, within 4 float32 ulps: qwen3's
    q_scale and k_scale (ones of the head dim) after the attention
    weights."""
    ref = load_reference()
    cfg = _cfg(case)
    want = _ref_params(cfg)
    got = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    assert transformer.count_params(got) == \
        ref.transformer.count_params(want)
    assert transformer.active_params(cfg, got) == \
        ref.transformer.active_params(_ref_cfg(cfg), want)
    assert ("q_scale" in got["blocks"]["attn"]) == cfg.qk_norm
    for path, w in _leaves(want):
        g = _get(got, path)
        assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix(
            "torch.") == str(w.dtype), path
        np.testing.assert_allclose(g.numpy(), w, rtol=4 * 2.0 ** -23,
                                   atol=1e-30, err_msg=str(path))


@pytest.mark.parametrize("case", CASES)
def test_params_from_jax_gives_the_same_forward(case):
    """The port's own init and the reference's tree carried across give
    the same prefill (the weights differ by at most 4 float32 ulps)."""
    cfg = _cfg(case)
    toks = torch.tensor(_tokens(cfg, (2, 40), 3))
    outs = [make_prefill_step(cfg, 44)(params, {"tokens": toks})[0]
            for params in (transformer.init_params(cfg, rng.PRNGKey(0),
                                                   device="cpu"),
                           transformer.params_from_jax(cfg, _ref_params(cfg),
                                                       device="cpu"))]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=0,
                               atol=ATOL)


def test_params_from_jax_keeps_the_bf16_qk_scales():
    cfg = _cfg("qwen3-14b", param_dtype="bfloat16")
    pj = _ref_params(cfg, seed=2)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    for path, t in _leaves(pt):
        w = _get(pj, path)
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      w.view(np.int16))
    assert tuple(pt["blocks"]["attn"]["q_scale"].shape) == (2, 32)


# ---------------------------------------------------------------------------
# qk-norm inside gqa_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_cache", [False, True],
                         ids=["prefill", "decode"])
def test_gqa_attention_with_qk_norm_matches_reference(with_cache, dtype):
    """One attention layer of qwen3's smoke config with scales drawn away
    from one (so the norm's scale shows): the prompt's causal attention
    and, with a cache of 8 filled slots, one decode step.  float32 within
    1e-5, bf16 within 2 bf16 ulps of the output's scale."""
    ref = load_reference()
    cfg = _cfg("qwen3-14b", param_dtype=dtype)
    rcfg = _ref_cfg(cfg)
    pj = jax.tree.map(np.asarray, ref.attention.init_attn(
        rcfg, jax.random.PRNGKey(5)))
    rs = np.random.default_rng(5)
    for name in ("q_scale", "k_scale"):
        pj[name] = (1 + 0.5 * rs.standard_normal(cfg.head_dim)).astype(
            pj[name].dtype)
    pt = transformer.params_from_jax(None, pj, "cpu")
    B, T = 2, 1 if with_cache else 24
    x = rs.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.tensor(x).to(getattr(torch, dtype))
    q_pos = np.broadcast_to(np.arange(8, 8 + T) if with_cache
                            else np.arange(T), (B, T)).astype(np.int32)
    cj = ct = None
    kv_pos = q_pos
    if with_cache:
        S = 16
        kv_pos = np.broadcast_to(np.where(np.arange(S) <= 8, np.arange(S),
                                          -1), (B, S)).astype(np.int32)
        shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
        kv = {k: rs.standard_normal(shape).astype(np.float32)
              for k in ("k", "v")}
        cj = {k: jnp.asarray(a, jnp.dtype(dtype)) for k, a in kv.items()}
        ct = {k: torch.tensor(a).to(getattr(torch, dtype))
              for k, a in kv.items()}
    oj, _ = ref.attention.gqa_attention(
        rcfg, jax.tree.map(jnp.asarray, pj), xj, jnp.asarray(q_pos),
        jnp.asarray(kv_pos), cj)
    with torch.no_grad():
        ot, _ = attention.gqa_attention(cfg, pt, xt, torch.tensor(q_pos),
                                        torch.tensor(kv_pos), ct)
    oj = np.asarray(oj, np.float32)
    assert ot.dtype == xt.dtype
    atol = F32_ATOL if dtype == "float32" else \
        2 * 2.0 ** -8 * np.abs(oj).max()
    np.testing.assert_allclose(ot.float().numpy(), oj, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_cache_shapes_match_reference(name):
    """The full configs' caches at batch 4 and 1056 positions (danube's:
    a ring of its 4096 window at batch 2 and 8224 positions)."""
    ref = load_reference()
    cfg = configs.get_config(name)
    B, S = (2, 8224) if cfg.sliding_window else (4, 1056)
    want = ref.kvcache.cache_shapes(_ref_cfg(cfg), B, S)
    got = kvcache.cache_shapes(cfg, B, S)
    assert set(got) == set(want) == {"pos", "layers"}
    for k, (shape, dtype) in got["layers"].items():
        assert shape == want["layers"][k][0], k
        assert str(dtype).removeprefix("torch.") == \
            jnp.dtype(want["layers"][k][1]).name
    slots = 4096 if cfg.sliding_window else S
    assert got["layers"]["k"][0] == (cfg.num_layers, B, slots,
                                     cfg.num_kv_heads, cfg.head_dim)


# ---------------------------------------------------------------------------
# prefill, decode, serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt", [40, 160])
@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_steps_match_reference(case, prompt):
    """The reference's jitted prefill and three greedy decode steps:
    last-token logits within 1e-4, tokens equal, every cache leaf within
    1e-4.  Prompt 160 passes the smoke window of 128 (danube3 and its
    width-120 variant): their caches are 128-slot rings."""
    ref = load_reference()
    cfg = _cfg(case)
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=prompt)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    total = prompt + 3
    toks = _tokens(cfg, (2, prompt), prompt)
    lj, cj = jax.jit(ref.steps.make_prefill_step(rcfg, total))(
        pj, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, ct = make_prefill_step(cfg, total)(pt, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=ATOL)
    slots = kvcache.cache_len(cfg, total)
    assert ct["layers"]["k"].shape[2] == slots
    nj = jnp.argmax(lj, -1).astype(jnp.int32)
    nt = torch.argmax(lt, -1)
    dec_j = jax.jit(ref.steps.make_decode_step(rcfg))
    dec_t = make_decode_step(cfg)
    for _ in range(total - prompt):
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        nj, cj = dec_j(pj, {"tokens": nj[:, None], "cache": cj})
        nt, ct = dec_t(pt, {"tokens": nt[:, None], "cache": ct})
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert ct["pos"] == int(cj["pos"])
    for k in ("k", "v"):
        np.testing.assert_allclose(ct["layers"][k].numpy(),
                                   np.asarray(cj["layers"][k]), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("case", ["h2o-danube-3-4b", "width120"])
def test_decode_past_the_window_matches_the_full_forward(case):
    """A prompt of 200 past the window of 128, then 8 decode steps
    through the ring, against the reference's no-cache forward over the
    whole sequence (its relative 5e-3, tests/test_models.py) and its own
    prefill and decode (1e-4)."""
    ref = load_reference()
    cfg = _cfg(case)
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=9)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    S, n = 200, 8
    toks = _tokens(cfg, (1, S + n), 9)
    full, _, _ = ref.transformer.forward(
        rcfg, pj, {"tokens": jnp.asarray(toks, jnp.int32)})
    full = np.asarray(full)
    scale = np.abs(full).max()
    cache = kvcache.init_cache(cfg, 1, S + n, device="cpu")
    assert cache["layers"]["k"].shape[2] == 128
    cj = ref.kvcache.init_cache(rcfg, 1, S + n)
    out, _, cache = transformer.forward(
        cfg, pt, {"tokens": torch.tensor(toks[:, :S])}, cache=cache)
    out_j, _, cj = ref.transformer.forward(
        rcfg, pj, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)}, cache=cj)
    assert np.abs(out.numpy() - full[:, :S]).max() / scale < 5e-3
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0,
                               atol=ATOL)
    for t in range(S, S + n):
        tok = toks[:, t:t + 1]
        out, _, cache = transformer.forward(
            cfg, pt, {"tokens": torch.tensor(tok)}, cache=cache)
        out_j, _, cj = ref.transformer.forward(
            rcfg, pj, {"tokens": jnp.asarray(tok, jnp.int32)}, cache=cj)
        assert np.abs(out.numpy()[:, 0] - full[:, t]).max() / scale < 5e-3
        np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0,
                                   atol=ATOL)
    assert cache["pos"] == S + n


@pytest.mark.parametrize("arch,prompt", [("qwen3-14b", 40),
                                         ("phi3-mini-3.8b", 40),
                                         ("h2o-danube-3-4b", 160)])
def test_serve_gives_the_reference_tokens(arch, prompt):
    ref = load_reference()
    ref_lines, lines = [], []
    want = ref.serve.serve(arch, 2, prompt, 6, smoke=True,
                           log=ref_lines.append)
    got = port_serve.serve(arch, 2, prompt, 6, smoke=True, log=lines.append,
                           device="cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lines[0] == ref_lines[0]


def test_serve_takes_a_weight_tree():
    """``serve(..., params=tree)`` serves that tree: the reference's tree
    from PRNGKey(3), greedy through the reference's jitted prefill and
    decode, gives the port's tokens."""
    ref = load_reference()
    cfg = _cfg("qwen3-14b")
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=3)
    got = port_serve.serve(cfg, 2, 40, 4, log=lambda _: None, device="cpu",
                           params=transformer.params_from_jax(cfg, pj,
                                                              "cpu"))
    toks = ref.data.synthetic_tokens(jax.random.PRNGKey(1), 2, 40,
                                     cfg.vocab_size)
    logits, cache = jax.jit(ref.steps.make_prefill_step(rcfg, 44))(
        pj, {"tokens": toks})
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [nxt]
    decode = jax.jit(ref.steps.make_decode_step(rcfg))
    for _ in range(3):
        nxt, cache = decode(pj, {"tokens": nxt[:, None], "cache": cache})
        want.append(nxt)
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack([np.asarray(t) for t in want], 1))


@pytest.mark.parametrize("case,head,window", [("width96", 96, None),
                                              ("width120", 120, 128)])
def test_width_variants_prefill_through_the_kernel_module(monkeypatch, case,
                                                          head, window):
    """The width variants' prefill calls flash attention once a layer at
    the published head dim, (B, T, H, d) q and (B, T, Hkv, d) v, with
    the window."""
    cfg = _cfg(case)
    seen = []
    flash = attention.flash_attention_heads

    def spy(q, k, v, window=None, k_shared=None):
        seen.append((tuple(q.shape), tuple(v.shape), window))
        return flash(q, k, v, window, k_shared)

    monkeypatch.setattr(attention, "flash_attention_heads", spy)
    params = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    make_prefill_step(cfg, 163)(params, {"tokens": torch.zeros(
        2, 160, dtype=torch.long)})
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    assert seen == [((2, 160, H, head), (2, 160, Hkv, head), window)] * 2


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["qwen3-14b", "width120"])
def test_train_step_matches_reference(case):
    """One SGD step on the KD loss (qk-norm's scales and the windowed
    width-120 variant through the reference's differentiable attention):
    loss, ce and kd within 1e-5, every updated parameter within 1e-5."""
    ref = load_reference()
    cfg = _cfg(case)
    pj = ref.transformer.init_params(_ref_cfg(cfg), jax.random.PRNGKey(0))
    p = transformer.params_from_jax(cfg, jax.tree.map(np.asarray, pj), "cpu")
    toks = _tokens(cfg, (2, 160), 1)
    g = np.random.default_rng(2).random((cfg.fd_buckets, cfg.fd_buckets))
    gout = (g / g.sum(-1, keepdims=True)).astype(np.float32)
    want_p, want_m = jax.jit(ref.steps.make_train_step(_ref_cfg(cfg)))(
        pj, {"tokens": jnp.asarray(toks), "gout": jnp.asarray(gout)})
    got_p, got_m = steps.make_train_step(cfg)(
        p, {"tokens": torch.tensor(toks), "gout": torch.tensor(gout)})
    for k in ("loss", "ce", "kd", "aux"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=0, atol=F32_ATOL)
    for path, w in _leaves(jax.tree.map(np.asarray, want_p)):
        np.testing.assert_allclose(_get(got_p, path).numpy(), w, rtol=0,
                                   atol=F32_ATOL, err_msg=str(path))
    if cfg.qk_norm:
        moved = (got_p["blocks"]["attn"]["q_scale"]
                 - p["blocks"]["attn"]["q_scale"]).abs().max()
        assert float(moved) > 0
