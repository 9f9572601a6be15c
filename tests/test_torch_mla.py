"""The port's multi-head latent attention (MLA, deepseek-v2-236b) against
the reference, on the CPU: the config and its two presets, init and the
weight bridge, ``mla_attention`` (the prompt's per-head path and the
absorbed decode), the latent cache, prefill then decode, serve, the
published routing, ``active_params`` and one train step.

Configs: the smoke config (float32, 2 layers, 4 heads, nope 32 + rope 16
= a q.k width of 48, values 32, kv_lora 64, 4 experts top 2),
``configs/deepseek_v2_236b.py::width192_smoke`` (the published head
shape: nope 128 + rope 64 = 192, values 128; its prefill reaches flash
attention at (192, 128) through ``prefill_attention``, the plain version
here) and ``routing_smoke`` (d_model 5120, 160 experts, top 6, 2 shared,
capacity factor 1.25 in groups of 512).

Weights are the reference's ``init_params`` tree carried across by
``params_from_jax`` (and, for the init itself, drawn by both from the
same key); inputs are drawn from a seed with numpy.  Tolerances: logits
and cache leaves within 1e-4 (float32 on both sides, another summation
order), an attention layer within 1e-5 in float32 and 2 bf16 ulps of the
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
from repro_torch.configs import deepseek_v2_236b
from repro_torch.launch import serve as port_serve
from repro_torch.launch import steps
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention, kvcache, moe, transformer
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401

ARCH = "deepseek-v2-236b"
ATOL = 1e-4
F32_ATOL = 1e-5
CASES = ["smoke", "width192"]


def _cfg(case="smoke", **kw):
    cfg = {"smoke": lambda: configs.get_config(ARCH + "-smoke"),
           "width192": deepseek_v2_236b.width192_smoke,
           "routing": deepseek_v2_236b.routing_smoke}[case]()
    return dataclasses.replace(cfg, **kw)


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


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _dtype_name(dt):
    return str(dt).removeprefix("torch.")


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
    assert mine.v_head == theirs.v_head
    assert mine.is_moe and mine.attn_type == "mla"


def test_presets_keep_the_published_head_shape_and_routing():
    full, w192, routing = (configs.get_config(ARCH), _cfg("width192"),
                           _cfg("routing"))
    shape = (full.head_dim + full.rope_head_dim, full.v_head)
    assert shape == (192, 128)
    assert (w192.head_dim + w192.rope_head_dim, w192.v_head) == shape
    assert w192.num_heads == 4 and w192.kv_lora_rank == _cfg().kv_lora_rank
    for f in ("d_model", "num_experts", "top_k", "num_shared_experts",
              "capacity_factor", "moe_group_size"):
        assert getattr(routing, f) == getattr(full, f), f
    assert routing.moe_d_ff == 64 and routing.num_layers == 2
    assert moe.capacity(full, 512) == moe.capacity(routing, 512) == 24


@pytest.mark.parametrize("case", CASES)
def test_init_params_match_reference(case):
    """The same key gives the same model within 4 float32 ulps: the MLA
    leaves (wq_a, q_norm, wq_b, wkv_a, kv_norm, wk_b, wv_b, wo) from the
    reference's split of 10 keys."""
    ref = load_reference()
    cfg = _cfg(case)
    want = _ref_params(cfg)
    got = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    assert set(got["blocks"]["attn"]) == {"wq_a", "q_norm", "wq_b", "wkv_a",
                                          "kv_norm", "wk_b", "wv_b", "wo"}
    assert transformer.count_params(got) == \
        ref.transformer.count_params(want)
    for path, w in _leaves(want):
        g = _get(got, path)
        assert tuple(g.shape) == w.shape and _dtype_name(g.dtype) == \
            str(w.dtype), path
        np.testing.assert_allclose(g.numpy(), w, rtol=4 * 2.0 ** -23,
                                   atol=1e-30, err_msg=str(path))


@pytest.mark.parametrize("case", CASES)
def test_params_from_jax_gives_the_same_forward(case):
    cfg = _cfg(case)
    toks = torch.tensor(_tokens(cfg, (2, 40), 3))
    outs = [make_prefill_step(cfg, 44)(params, {"tokens": toks})[0]
            for params in (transformer.init_params(cfg, rng.PRNGKey(0),
                                                   device="cpu"),
                           transformer.params_from_jax(cfg, _ref_params(cfg),
                                                       device="cpu"))]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=0,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# one MLA layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_cache", [False, True],
                         ids=["prompt", "decode"])
@pytest.mark.parametrize("case", CASES)
def test_mla_attention_matches_reference(case, with_cache, dtype):
    """One layer with q_norm and kv_norm drawn away from one: the prompt
    (T 24, written into a 32-slot cache) and one absorbed decode step at
    position 8 of a 16-slot cache whose first 8 slots hold latents.
    float32 within 1e-5, bf16 within 2 bf16 ulps of the output's scale;
    the written ckv and kr equal the reference's."""
    ref = load_reference()
    cfg = _cfg(case, param_dtype=dtype)
    rcfg = _ref_cfg(cfg)
    pj = jax.tree.map(np.asarray, ref.attention.init_attn(
        rcfg, jax.random.PRNGKey(5)))
    rs = np.random.default_rng(5)
    for name in ("q_norm", "kv_norm"):
        pj[name] = (1 + 0.5 * rs.standard_normal(pj[name].shape)).astype(
            pj[name].dtype)
    pt = transformer.params_from_jax(None, pj, "cpu")
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    B, T = 2, 1 if with_cache else 24
    S = 16 if with_cache else 32
    x = rs.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(8, 8 + T) if with_cache
                            else np.arange(T), (B, T)).astype(np.int32)
    kv_pos = q_pos
    lat = {"ckv": rs.standard_normal((B, S, cfg.kv_lora_rank)),
           "kr": rs.standard_normal((B, S, cfg.rope_head_dim))}
    if with_cache:
        kv_pos = np.broadcast_to(np.where(np.arange(S) <= 8, np.arange(S),
                                          -1), (B, S)).astype(np.int32)
        for a in lat.values():
            a[:, 8:] = 0
    else:
        lat = {k: np.zeros_like(a) for k, a in lat.items()}
    cj = {k: jnp.asarray(a.astype(np.float32), jdt) for k, a in lat.items()}
    ct = {k: torch.tensor(a.astype(np.float32)).to(tdt)
          for k, a in lat.items()}
    oj, new_cj = ref.attention.mla_attention(
        rcfg, jax.tree.map(jnp.asarray, pj), jnp.asarray(x, jdt),
        jnp.asarray(q_pos), jnp.asarray(kv_pos), cj)
    with torch.no_grad():
        ot, new_ct = attention.mla_attention(
            cfg, pt, torch.tensor(x).to(tdt), torch.tensor(q_pos),
            torch.tensor(kv_pos), ct)
    assert new_ct is ct and ot.dtype == tdt
    oj = np.asarray(oj, np.float32)
    atol = F32_ATOL if dtype == "float32" else \
        2 * 2.0 ** -8 * np.abs(oj).max()
    np.testing.assert_allclose(ot.float().numpy(), oj, rtol=0, atol=atol)
    for k in ("ckv", "kr"):
        want = np.asarray(new_cj[k], np.float32)
        assert ct[k].dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(ct[k].numpy(), want, rtol=0,
                                       atol=F32_ATOL, err_msg=k)
        else:   # the same bf16 values but where a product rounds apart
            got = ct[k].float().numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2 * 2.0 ** -8
                                       * np.abs(want).max(), err_msg=k)
            assert (got == want).mean() > 0.9, k


def test_mla_prefill_longer_than_the_cache_raises():
    """The reference asserts a linear cache at least as long as the
    prompt; the port raises."""
    cfg = _cfg()
    p = transformer.params_from_jax(None, jax.tree.map(
        np.asarray, load_reference().attention.init_attn(
            _ref_cfg(cfg), jax.random.PRNGKey(0))), "cpu")
    cache = {"ckv": torch.zeros(1, 8, cfg.kv_lora_rank),
             "kr": torch.zeros(1, 8, cfg.rope_head_dim)}
    pos = torch.arange(12)[None]
    with pytest.raises(ValueError, match="longer than the linear cache"):
        attention.mla_attention(cfg, p, torch.zeros(1, 12, cfg.d_model), pos,
                                pos, cache)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [ARCH, ARCH + "-smoke"])
def test_cache_shapes_match_reference(name):
    """The latent cache: ckv (L, B, Sc, kv_lora) and kr (L, B, Sc, rope)
    in the parameters' dtype; (60, 2, 64, 512) and (60, 2, 64, 64) at
    full width (tests/test_steps.py's deepseek case, batch 2, 64
    positions)."""
    ref = load_reference()
    cfg = configs.get_config(name)
    want = ref.kvcache.cache_shapes(_ref_cfg(cfg), 2, 64)
    got = kvcache.cache_shapes(cfg, 2, 64)
    assert set(got) == set(want) == {"pos", "layers"}
    assert set(got["layers"]) == set(want["layers"]) == {"ckv", "kr"}
    for k, (shape, dtype) in got["layers"].items():
        assert shape == want["layers"][k][0], k
        assert _dtype_name(dtype) == jnp.dtype(want["layers"][k][1]).name
    cache = kvcache.init_cache(cfg, 2, 64, device="cpu")
    for k, (shape, dtype) in got["layers"].items():
        assert tuple(cache["layers"][k].shape) == shape
        assert cache["layers"][k].dtype == dtype
    if name == ARCH:
        assert got["layers"]["ckv"][0] == (60, 2, 64, 512)
        assert got["layers"]["kr"][0] == (60, 2, 64, 64)


# ---------------------------------------------------------------------------
# prefill, decode, serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_prefill_then_decode_matches_reference(case):
    """B 1, S 160 (tests/test_models.py's deepseek case): the prefill of
    160 tokens and one decode step, against the reference's full forward
    over 161 (relative 5e-3, as there) and against the reference's own
    prefill and decode: logits within 1e-4, the latent cache within
    1e-4."""
    ref = load_reference()
    cfg = _cfg(case)
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=1)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    S = 160
    toks = _tokens(cfg, (1, S + 1), 1)
    full, _, _ = ref.transformer.forward(
        rcfg, pj, {"tokens": jnp.asarray(toks, jnp.int32)})
    full = np.asarray(full)
    scale = np.abs(full).max()
    cache = kvcache.init_cache(cfg, 1, S + 1, device="cpu")
    cj = ref.kvcache.init_cache(rcfg, 1, S + 1)
    pre, _, cache = transformer.forward(
        cfg, pt, {"tokens": torch.tensor(toks[:, :S])}, cache=cache)
    pre_j, _, cj = ref.transformer.forward(
        rcfg, pj, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)}, cache=cj)
    assert np.abs(pre.numpy() - full[:, :S]).max() / scale < 5e-3
    np.testing.assert_allclose(pre.numpy(), np.asarray(pre_j), rtol=0,
                               atol=ATOL)
    dec, _, cache = transformer.forward(
        cfg, pt, {"tokens": torch.tensor(toks[:, S:])}, cache=cache)
    dec_j, _, cj = ref.transformer.forward(
        rcfg, pj, {"tokens": jnp.asarray(toks[:, S:], jnp.int32)}, cache=cj)
    assert np.abs(dec.numpy()[:, 0] - full[:, S]).max() / scale < 5e-3
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_j), rtol=0,
                               atol=ATOL)
    assert cache["pos"] == int(cj["pos"]) == S + 1
    for k in ("ckv", "kr"):
        np.testing.assert_allclose(cache["layers"][k].numpy(),
                                   np.asarray(cj["layers"][k]), rtol=0,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_steps_match_reference(case):
    """The reference's jitted prefill (prompt 40 into 43 slots) and three
    greedy decode steps: last-token logits within 1e-4, tokens equal."""
    ref = load_reference()
    cfg = _cfg(case)
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=2)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    prompt, total = 40, 43
    toks = _tokens(cfg, (2, prompt), 2)
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


def test_serve_gives_the_reference_tokens():
    ref = load_reference()
    ref_lines, lines = [], []
    want = ref.serve.serve(ARCH, 2, 40, 6, smoke=True, log=ref_lines.append)
    got = port_serve.serve(ARCH, 2, 40, 6, smoke=True, log=lines.append,
                           device="cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lines[0] == ref_lines[0]


@pytest.mark.parametrize("case,width", [("smoke", (48, 32)),
                                        ("width192", (192, 128))])
def test_prefill_goes_through_the_kernel_module(monkeypatch, case, width):
    """The prefill calls flash attention once a layer at (B, T, H, d) q,
    (B, T, H, nope) k, the one rope key (B, T, rope) shared by every head
    and (B, T, H, dv) v: (192, 128) for the width-192 variant, with no
    window."""
    cfg = _cfg(case)
    seen = []
    flash = attention.flash_attention_heads

    def spy(q, k, v, window=None, k_shared=None):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                     tuple(k_shared.shape), window))
        return flash(q, k, v, window, k_shared)

    monkeypatch.setattr(attention, "flash_attention_heads", spy)
    params = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    make_prefill_step(cfg, 44)(params, {"tokens": torch.zeros(
        2, 40, dtype=torch.long)})
    d, dv = width
    H, nope, rp = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim
    assert seen == [((2, 40, H, d), (2, 40, H, nope), (2, 40, H, dv),
                     (2, 40, rp), None)] * 2


# ---------------------------------------------------------------------------
# the published routing and the parameter counts
# ---------------------------------------------------------------------------

def _places(oh):
    """(G, Sg*K, E) one-hot picks -> each pick's place in its expert's
    queue (the exclusive cumsum over the flattened order)."""
    return ((np.cumsum(oh, 1) - oh) * oh).sum(-1)


def test_published_routing_matches_reference(monkeypatch):
    """``routing_smoke()``: 160 experts, top 6, capacity factor 1.25 in a
    group of 512 at d_model 5120 (prompt 256, batch 2: one group of 512,
    24 places an expert).  The reference's jitted prefill and one greedy
    decode step: last-token logits within 1e-4, tokens equal.  Each
    prefill layer keeps the places the reference keeps (the reference's
    router lines run on its own layer input, read out through
    ``jax.debug.callback``), and drops some."""
    ref = load_reference()
    cfg = _cfg("routing")
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=5)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    C = moe.capacity(cfg, 512)
    kept, kept_j = [], []
    real = moe.route

    def counting(c, router, xg):
        out = real(c, router, xg)
        G, Sg, K = out[2].shape
        oh = torch.nn.functional.one_hot(out[2], c.num_experts)
        kept.append(_places(oh.reshape(G, Sg * K, -1).numpy()) < C)
        return out

    real_j = ref.transformer.moe_ffn

    def counting_j(c, p, x, constrain=None):
        # the reference moe_ffn's routing lines (one group of 512)
        xg = x.reshape(1, -1, c.d_model)
        logits = jnp.einsum("gsd,de->gse", xg, p["router"].astype(x.dtype),
                            preferred_element_type=jnp.float32)
        _, top = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), c.top_k)
        oh = jax.nn.one_hot(top, c.num_experts, dtype=jnp.float32)
        jax.debug.callback(lambda a: kept_j.append(np.asarray(a)),
                           oh.reshape(1, -1, c.num_experts), ordered=True)
        return real_j(c, p, x, constrain=constrain)

    monkeypatch.setattr(moe, "route", counting)
    monkeypatch.setattr(ref.transformer, "moe_ffn", counting_j)
    prompt, total = 256, 258
    toks = _tokens(cfg, (2, prompt), 5)
    lj, cj = jax.jit(ref.steps.make_prefill_step(rcfg, total))(
        pj, {"tokens": jnp.asarray(toks, jnp.int32)})
    jax.effects_barrier()
    lt, ct = make_prefill_step(cfg, total)(pt, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=ATOL)
    assert C == 24 and len(kept) == len(kept_j) == 2
    for k, oh in zip(kept, kept_j):
        assert k.size == 512 * 6 and not k.all()
        np.testing.assert_array_equal(k, _places(oh) < C)
    nj = jnp.argmax(lj, -1).astype(jnp.int32)
    nt = torch.argmax(lt, -1)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    nj, cj = jax.jit(ref.steps.make_decode_step(rcfg))(
        pj, {"tokens": nj[:, None], "cache": cj})
    nt, ct = make_decode_step(cfg)(pt, {"tokens": nt[:, None], "cache": ct})
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


@pytest.mark.parametrize("name", [ARCH, ARCH + "-smoke"])
def test_active_params_match_reference(name):
    """Active parameters a token (the routed experts' top_k / E share):
    at full width from the reference's shapes (``jax.eval_shape``), the
    port's count on shape-only tensors: 3,972,116,480 a layer and
    1,048,581,120 in the embeddings; all 60 layers, and the 6 of 60 that
    the card serves (24,881,280,000; 3,081,384,960 active)."""
    ref = load_reference().transformer
    cfg = configs.get_config(name)
    for layers in ((cfg.num_layers, 6) if name == ARCH
                   else (cfg.num_layers,)):
        c = dataclasses.replace(cfg, num_layers=layers)
        shapes = jax.eval_shape(lambda: ref.init_params(
            _ref_cfg(c), jax.random.PRNGKey(0)))
        meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                            shapes)
        want_total = ref.count_params(shapes)
        want = ref.active_params(_ref_cfg(c), shapes)
        assert transformer.count_params(meta) == want_total
        assert transformer.active_params(c, meta) == want
        if name == ARCH:
            assert want_total == 1048581120 + layers * 3972116480
        if name == ARCH and layers == 6:
            assert (want_total, want) == (24881280000, 3081384960)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_no_cache_forward_matches_reference(grad):
    """The training forward over positions 0..T-1: without a gradient
    through flash attention's plain version at (48, 32), with one through
    ``masked_attention`` with dv != d; logits within 1e-4, the router
    loss within 1e-5."""
    ref = load_reference()
    cfg = _cfg()
    pj = _ref_params(cfg, seed=7)
    p = transformer.params_from_jax(cfg, pj, "cpu")
    toks = _tokens(cfg, (2, 64), 7)
    want, aux, _ = ref.transformer.forward(_ref_cfg(cfg), pj,
                                           {"tokens": jnp.asarray(toks)})
    with torch.set_grad_enabled(grad):
        if grad:
            p = steps.tree_map(lambda t: t.requires_grad_(True), p)
        got, got_aux, cache = transformer.forward(
            cfg, p, {"tokens": torch.tensor(toks)})
    assert cache is None and got.requires_grad == grad
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(got_aux.detach()), float(aux), rtol=0,
                               atol=F32_ATOL)


def test_train_step_matches_reference():
    """One SGD step on the KD loss through the MLA path: loss, ce, kd and
    aux within 1e-5, every updated parameter within 1e-5; the latent
    projections move."""
    ref = load_reference()
    cfg = _cfg()
    pj = ref.transformer.init_params(_ref_cfg(cfg), jax.random.PRNGKey(0))
    p = transformer.params_from_jax(cfg, jax.tree.map(np.asarray, pj), "cpu")
    toks = _tokens(cfg, (2, 64), 1)
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
    for name in ("wkv_a", "wk_b", "wv_b", "kv_norm"):
        moved = (got_p["blocks"]["attn"][name]
                 - p["blocks"]["attn"][name]).abs().max()
        assert float(moved) > 0, name


def test_favg_step_matches_reference():
    """The no-grad favg table (its forward through flash attention's
    plain version at (48, 32)): within 1e-5 of the reference's, its
    non-empty rows distributions."""
    ref = load_reference()
    cfg = _cfg()
    pj = _ref_params(cfg, seed=8)
    p = transformer.params_from_jax(cfg, pj, "cpu")
    toks = _tokens(cfg, (4, 64), 8)
    want = jax.jit(ref.steps.make_favg_step(_ref_cfg(cfg)))(
        pj, {"tokens": jnp.asarray(toks)})
    got = steps.make_favg_step(cfg)(p, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)
    sums = got.sum(-1).numpy()
    np.testing.assert_allclose(sums[sums > 0], 1.0, atol=1e-4)

