"""The port's MoE family (qwen2-moe-a2.7b: ``models/moe.py``, 60 routed
and 4 shared experts, top 4) against the reference, on the CPU: the
capacity rule, init and the weight bridge, ``moe_ffn`` (dropless and
dropping, float32 and bf16, the router's float32 logits and top-k
ties), active parameters, the smoke config's prefill and greedy decode
and one train step with the router loss's gradient.

The smoke config is the reference's: 4 experts, top 2, one shared
expert, group size 64, capacity factor 2.0 (dropless: a group's
capacity holds every token).  The dropping case sets capacity factor
1.0; ``routing_smoke()`` has the published routing (60 experts, top 4,
capacity factor 1.25, groups of 512) at d_model 2048.  Weights are the reference's own ``init_params`` tree carried
across by ``params_from_jax``; inputs are drawn from a seed with numpy.
Tolerances: ``moe_ffn``'s y and aux within 1e-5 in float32 (another
summation order), logits within 1e-4, one SGD step within 1e-5; init
within 4 float32 ulps; bf16 y within 4 bf16 ulps of its largest entry.
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
from repro_torch.models import kvcache, moe, transformer
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401

ATOL = 1e-4
F32_ATOL = 1e-5
ARCH = "qwen2-moe-a2.7b"


def _cfg(**kw):
    return dataclasses.replace(configs.get_config(ARCH + "-smoke"), **kw)


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


def _moe_params(cfg, seed):
    """The reference's ``init_moe`` tree (numpy) and the port's copy."""
    pj = jax.tree.map(np.asarray, load_reference().moe.init_moe(
        _ref_cfg(cfg), jax.random.PRNGKey(seed)))
    return pj, transformer.params_from_jax(None, pj, "cpu")


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ---------------------------------------------------------------------------
# capacity, init, the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 2.0])
def test_capacity_matches_reference(factor):
    """The round-up to a multiple of 4 with a floor of 4, over group
    sizes, top-k and expert counts."""
    ref = load_reference().moe
    for E in (4, 8, 60, 64, 160):
        for K in (1, 2, 4, 6):
            cfg = _cfg(num_experts=E, top_k=K, capacity_factor=factor)
            for Sg in (1, 2, 4, 7, 40, 64, 100, 512, 1000, 4096):
                assert moe.capacity(cfg, Sg) == ref.capacity(_ref_cfg(cfg),
                                                             Sg), (E, K, Sg)
    # the full config's prefill group (batch 4, prompt 1024) and decode
    full = configs.get_config(ARCH)
    assert moe.capacity(full, 512) == 44 and moe.capacity(full, 4) == 4


@pytest.mark.parametrize("name,T,want", [
    (ARCH, 4096, 512), (ARCH, 1000, 500), (ARCH, 4, 4),
    (ARCH + "-smoke", 80, 40), (ARCH + "-smoke", 40, 40),
    (ARCH + "-smoke", 97, 1)])
def test_group_size_is_the_largest_divisor(name, T, want):
    """The largest group size <= moe_group_size (512 at full width, 64
    in the smoke config) dividing T; at decode T is the batch."""
    assert moe.group_size(configs.get_config(name), T) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [1, 0])
def test_init_moe_matches_reference(shared, dtype):
    """The same key gives the same experts (normals within 4 float32
    ulps, as every init of the port; the bf16 casts equal), the router
    in float32 either way, the routed w2 divided by sqrt(F) as the
    reference does, the shared w2 from ``fold_in(ks[4], 7)``."""
    cfg = _cfg(num_shared_experts=shared, param_dtype=dtype)
    want = jax.tree.map(np.asarray, load_reference().moe.init_moe(
        _ref_cfg(cfg), jax.random.PRNGKey(3)))
    got = moe.init_moe(cfg, rng.PRNGKey(3))
    assert set(got) == set(want)
    assert ("shared" in got) == bool(shared)
    assert got["router"].dtype == torch.float32
    for path, w in _leaves(want):
        g = _get(got, path)
        assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix(
            "torch.") == str(w.dtype), path
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16), str(path))
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=4 * 2.0 ** -23,
                                       atol=1e-30, err_msg=str(path))


def test_init_params_moe_matches_reference():
    """The whole smoke model: ``moe`` in place of ``mlp`` in each block,
    from the block key's second split, stacked over the layers."""
    ref = load_reference()
    cfg = _cfg()
    want = _ref_params(cfg)
    got = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    assert transformer.count_params(got) == \
        ref.transformer.count_params(want)
    assert "moe" in got["blocks"] and "mlp" not in got["blocks"]
    for path, w in _leaves(want):
        g = _get(got, path)
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, rtol=4 * 2.0 ** -23,
                                   atol=1e-30, err_msg=str(path))


def test_params_from_jax_moe_tree_gives_the_same_forward():
    """bf16 bits kept on every leaf of an MoE tree (the router float32);
    in float32 the port's own init and the reference's tree give the same
    prefill."""
    cfg = _cfg(param_dtype="bfloat16")
    pj = _ref_params(cfg, seed=2)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    for path, t in _leaves(pt):
        w = _get(pj, path)
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            assert t.dtype == torch.float32, path
            np.testing.assert_array_equal(t.numpy(), w)
    cfg = _cfg()
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 40)))
    outs = [make_prefill_step(cfg, 44)(params, {"tokens": toks})[0]
            for params in (transformer.init_params(cfg, rng.PRNGKey(0),
                                                   device="cpu"),
                           transformer.params_from_jax(cfg, _ref_params(cfg),
                                                       device="cpu"))]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=0,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 40), (3, 64), (1, 1)])
@pytest.mark.parametrize("factor", [2.0, 1.0], ids=["dropless", "drops"])
def test_moe_ffn_matches_reference(factor, shape):
    """y and aux within 1e-5 in float32.  (2, 40): T 80 in two groups of
    40; (3, 64): three groups of 64; (1, 1): a decode step.  At capacity
    factor 1.0 a group of 64 with top 2 of 4 has 32 places an expert, so
    tokens are dropped; the test checks that some are."""
    ref = load_reference().moe
    cfg = _cfg(capacity_factor=factor)
    pj, pt = _moe_params(cfg, seed=sum(shape))
    x = _x(shape + (cfg.d_model,), seed=shape[1])
    yj, auxj = ref.moe_ffn(_ref_cfg(cfg), jax.tree.map(jnp.asarray, pj),
                           jnp.asarray(x))
    yt, auxt = moe.moe_ffn(cfg, pt, torch.tensor(x))
    assert yt.dtype == torch.float32 and auxt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=0,
                               atol=F32_ATOL)
    if factor == 1.0 and shape == (3, 64):
        _, _, idx = moe.route(cfg, pt["router"],
                              torch.tensor(x).reshape(3, 64, -1))
        per_expert = torch.nn.functional.one_hot(idx, 4).sum((1, 2))
        assert int(per_expert.max()) > moe.capacity(cfg, 64)


def _rounded_route(cfg, router, xg):
    """The router with its logits rounded to the tokens' dtype (a bf16
    product, the error the port must not make)."""
    logits = (xg @ router.to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, vals[..., :cfg.top_k], idx[..., :cfg.top_k]


def test_moe_ffn_bf16_keeps_the_router_logits_in_float32(monkeypatch):
    """bf16 tokens and experts at the published routing (60 experts, top
    4, 4 shared), 512 tokens: y within 4 bf16 ulps of its largest entry
    of the reference's, aux within 1e-5.  A router whose logits are
    rounded to bf16 picks other experts for some of these tokens (about
    10 of 512) and misses y's tolerance by ten times."""
    ref = load_reference().moe
    cfg = _cfg(param_dtype="bfloat16", num_experts=60, top_k=4,
               num_shared_experts=4, moe_d_ff=64)
    pj, pt = _moe_params(cfg, seed=7)
    x = _x((8, 64, cfg.d_model), seed=7)
    xj = jnp.asarray(x, jnp.bfloat16)
    yj, auxj = ref.moe_ffn(_ref_cfg(cfg), jax.tree.map(jnp.asarray, pj), xj)
    yj = np.asarray(yj, np.float32)
    xt = torch.tensor(x).bfloat16()
    atol = 4 * 2.0 ** -8 * np.abs(yj).max()

    def off(y, aux):
        return (float(np.abs(y.float().numpy() - yj).max()),
                abs(float(aux) - float(auxj)))

    yt, auxt = moe.moe_ffn(cfg, pt, xt)
    assert yt.dtype == torch.bfloat16
    dy, daux = off(yt, auxt)
    assert dy <= atol and daux <= F32_ATOL, (dy, atol, daux)
    picks = moe.route(cfg, pt["router"], xt.reshape(8, 64, -1))[2]
    monkeypatch.setattr(moe, "route", _rounded_route)
    rounded = moe.route(cfg, pt["router"], xt.reshape(8, 64, -1))[2]
    assert not torch.equal(picks, rounded)
    dy, _ = off(*moe.moe_ffn(cfg, pt, xt))
    assert dy > 10 * atol, (dy, atol)


def test_top_k_ties_break_by_the_lower_index():
    """A zero router gives every expert the same probability: the
    reference's ``jax.lax.top_k`` picks experts 0 and 1 for every token;
    so does the port (a stable descending sort), and y and aux agree."""
    ref = load_reference().moe
    cfg = _cfg()
    pj, pt = _moe_params(cfg, seed=5)
    pj = dict(pj, router=np.zeros_like(pj["router"]))
    pt = dict(pt, router=torch.zeros_like(pt["router"]))
    x = _x((2, 32, cfg.d_model), seed=5)
    _, gates, idx = moe.route(cfg, pt["router"],
                              torch.tensor(x).reshape(1, 64, -1))
    assert bool((idx == torch.tensor([0, 1])).all())
    assert bool((gates == 0.25).all())
    yj, auxj = ref.moe_ffn(_ref_cfg(cfg), jax.tree.map(jnp.asarray, pj),
                           jnp.asarray(x))
    yt, auxt = moe.moe_ffn(cfg, pt, torch.tensor(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=0,
                               atol=F32_ATOL)


@pytest.mark.parametrize("name", [ARCH, ARCH + "-smoke"])
def test_active_params_match_reference(name):
    """Active parameters a token (the routed experts' top_k / E share):
    at full width from the reference's shapes (``jax.eval_shape``), the
    port's count on shape-only tensors; 2,688,976,896 of 14,315,587,584
    for qwen2-moe-a2.7b."""
    ref = load_reference().transformer
    cfg = configs.get_config(name)
    shapes = jax.eval_shape(lambda: ref.init_params(
        _ref_cfg(cfg), jax.random.PRNGKey(0)))
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        shapes)
    want_total = ref.count_params(shapes)
    want = ref.active_params(_ref_cfg(cfg), shapes)
    assert transformer.count_params(meta) == want_total
    assert transformer.active_params(cfg, meta) == want
    if name == ARCH:
        assert (want_total, want) == (14315587584, 2688976896)


# ---------------------------------------------------------------------------
# the whole model: cache, prefill, decode, serve, train step
# ---------------------------------------------------------------------------

def test_moe_cache_is_the_dense_cache():
    """The reference's cache_shapes for the full config at batch 4 and
    1056 positions: (24, 4, 1056, 16, 128) keys and values; with the
    int8 cache (since A15-arch part 3) int8 keys and values and float32
    scales of (24, 4, 1056, 16), as the reference's."""
    ref = load_reference()
    cfg = configs.get_config(ARCH)
    want = ref.kvcache.cache_shapes(_ref_cfg(cfg), 4, 1056)
    got = kvcache.cache_shapes(cfg, 4, 1056)
    assert set(got) == set(want) == {"pos", "layers"}
    for k, (shape, dtype) in got["layers"].items():
        assert shape == want["layers"][k][0] == (24, 4, 1056, 16, 128)
        assert str(dtype).removeprefix("torch.") == \
            jnp.dtype(want["layers"][k][1]).name
    q = dataclasses.replace(cfg, kv_quant=True)
    want = ref.kvcache.cache_shapes(_ref_cfg(q), 4, 1056)
    got = kvcache.cache_shapes(q, 4, 1056)
    assert set(got["layers"]) == set(want["layers"])
    for k, (shape, dtype) in got["layers"].items():
        assert shape == want["layers"][k][0]
        assert str(dtype).removeprefix("torch.") == \
            jnp.dtype(want["layers"][k][1]).name
    assert got["layers"]["k_scale"] == ((24, 4, 1056, 16), torch.float32)


@pytest.mark.parametrize("factor", [2.0, 1.0], ids=["dropless", "drops"])
def test_prefill_and_decode_steps_match_reference(factor):
    """The reference's jitted prefill (prompt 40: two groups of 40) and
    three greedy decode steps (groups of the batch, 2): last-token logits
    within 1e-4, tokens equal, caches close."""
    ref = load_reference()
    cfg = _cfg(capacity_factor=factor)
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=4)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    prompt, total = 40, 43
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, prompt))
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
    assert ct["pos"] == int(cj["pos"])
    for k in ("k", "v"):
        np.testing.assert_allclose(ct["layers"][k].numpy(),
                                   np.asarray(cj["layers"][k]), rtol=0,
                                   atol=ATOL)


def test_published_routing_matches_reference(monkeypatch):
    """``routing_smoke()``: 60 experts, top 4, capacity factor 1.25 in a
    group of 512 at d_model 2048 (prompt 256, batch 2: one group of 512
    places 44 an expert).  The reference's jitted prefill and two greedy
    decode steps: last-token logits within 1e-4, tokens equal; the
    prefill drops places in both layers."""
    from repro_torch.configs.qwen2_moe_a2_7b import routing_smoke

    ref = load_reference()
    cfg = routing_smoke()
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=5)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    kept = []
    real = moe.route

    def counting(c, router, xg):
        out = real(c, router, xg)
        G, Sg, K = out[2].shape
        oh = torch.nn.functional.one_hot(out[2], c.num_experts)
        oh = oh.reshape(G, Sg * K, -1)
        place = ((oh.cumsum(1) - oh) * oh).sum(-1)
        kept.append((G * Sg * K, int((place < moe.capacity(c, Sg)).sum())))
        return out

    monkeypatch.setattr(moe, "route", counting)
    prompt, total = 256, 258
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, prompt))
    lj, cj = jax.jit(ref.steps.make_prefill_step(rcfg, total))(
        pj, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, ct = make_prefill_step(cfg, total)(pt, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=ATOL)
    assert moe.capacity(cfg, 512) == 44
    assert len(kept) == 2 and all(n == 2048 and k < n for n, k in kept)
    nj = jnp.argmax(lj, -1).astype(jnp.int32)
    nt = torch.argmax(lt, -1)
    dec_j = jax.jit(ref.steps.make_decode_step(rcfg))
    dec_t = make_decode_step(cfg)
    for _ in range(total - prompt):
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        nj, cj = dec_j(pj, {"tokens": nj[:, None], "cache": cj})
        nt, ct = dec_t(pt, {"tokens": nt[:, None], "cache": ct})
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


def test_forward_sums_the_router_loss_over_layers():
    """The no-cache forward's aux is the sum of the layers' router
    losses (the reference's scan carry), within 1e-5; a dense config's
    is 0."""
    ref = load_reference()
    cfg = _cfg()
    pj = _ref_params(cfg, seed=6)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 32))
    lj, auxj, _ = ref.transformer.forward(
        _ref_cfg(cfg), pj, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, auxt, _ = transformer.forward(cfg, pt, {"tokens": torch.tensor(toks)},
                                      remat=False)
    assert float(auxt) > 0
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), rtol=0,
                               atol=ATOL)


def test_train_step_matches_reference():
    """One SGD step on the KD loss plus the router loss (grad_accum 2, the
    config's): loss, ce, kd and aux within 1e-5, every updated parameter
    within 1e-5, and the router moved by aux's gradient as the
    reference's did."""
    ref = load_reference()
    cfg = _cfg()
    pj = ref.transformer.init_params(_ref_cfg(cfg), jax.random.PRNGKey(0))
    p = transformer.params_from_jax(cfg, jax.tree.map(np.asarray, pj), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 48))
    g = np.random.default_rng(2).random((cfg.fd_buckets, cfg.fd_buckets))
    gout = (g / g.sum(-1, keepdims=True)).astype(np.float32)
    want_p, want_m = jax.jit(ref.steps.make_train_step(_ref_cfg(cfg)))(
        pj, {"tokens": jnp.asarray(toks), "gout": jnp.asarray(gout)})
    got_p, got_m = steps.make_train_step(cfg)(
        p, {"tokens": torch.tensor(toks), "gout": torch.tensor(gout)})
    for k in ("loss", "ce", "kd", "aux"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=0, atol=F32_ATOL)
    assert float(got_m["aux"]) > 0
    for path, w in _leaves(jax.tree.map(np.asarray, want_p)):
        np.testing.assert_allclose(_get(got_p, path).numpy(), w, rtol=0,
                                   atol=F32_ATOL, err_msg=str(path))
    moved = (_get(got_p, ("blocks", "moe", "router"))
             - p["blocks"]["moe"]["router"]).abs().max()
    assert float(moved) > 0


def test_serve_gives_the_reference_tokens():
    ref = load_reference()
    ref_lines, lines = [], []
    want = ref.serve.serve(ARCH, 2, 40, 6, smoke=True, log=ref_lines.append)
    got = port_serve.serve(ARCH, 2, 40, 6, smoke=True, log=lines.append,
                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lines[0] == ref_lines[0] == \
        f"arch={ARCH} params=4.39M batch=2 prompt=40 gen=6"
