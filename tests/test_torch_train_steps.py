"""The port's LM training side against the reference, on the CPU: the
no-cache forward (dense, SSM, hybrid), the chunked attention branch,
the vocab bucketing, the chunked CE + KD loss, the train step with and
without gradient accumulation, and the four federated LM steps.

The port's cover for the reference's ``tests/test_steps.py`` step tests
(``:45``, ``:61``, ``:88``, ``:104``, ``:123``), which cannot run under
the installed jax (ROADMAP C1): each is held against the live reference
and also asserts what that test asserts, at its tolerances.

Weights are the reference's own ``init_params`` tree carried across by
``params_from_jax``; inputs are drawn from a seed with numpy.
Tolerances: float32 on both sides in another summation order — logits
within 1e-4 (sums of 256-wide products over a few layers), losses and
one SGD step's parameters within 1e-5, bucket log-probabilities within
1e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs, optim, rng
from repro_torch.core import outputs
from repro_torch.launch import steps
from repro_torch.models import attention, transformer
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401

LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
ARCHS = ["qwen2-0.5b", "mamba2-370m", "zamba2-2.7b"]


def _cfg(arch="qwen2-0.5b", **kw):
    return dataclasses.replace(configs.get_config(arch).smoke(), **kw)


def _ref_cfg(cfg):
    return load_reference().configs.ArchConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed=0):
    """(reference params, the port's copy on the CPU)."""
    pj = load_reference().transformer.init_params(_ref_cfg(cfg),
                                                  jax.random.PRNGKey(seed))
    return pj, transformer.params_from_jax(
        cfg, jax.tree.map(np.asarray, pj), "cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (sorted keys) as numpy."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree.detach().float().numpy() if torch.is_tensor(tree)
            else np.asarray(tree, np.float32)]


def _assert_trees_close(got, want, atol):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the no-cache forward and the chunked attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("arch", ARCHS)
def test_no_cache_forward_matches_reference(arch, grad):
    """Logits of the training forward (positions 0..T-1), through the
    kernel route's plain versions without a gradient and through the
    reference's math with one; ``return_hidden`` is the final-normed
    hidden that the loss unembeds."""
    cfg = _cfg(arch)
    pj, p = _params(cfg)
    toks = _tokens(cfg, (2, 64))
    ref = load_reference().transformer
    want, aux, cache = ref.forward(_ref_cfg(cfg), pj,
                                   {"tokens": jnp.asarray(toks)})
    batch = {"tokens": torch.tensor(toks)}
    with torch.set_grad_enabled(grad):
        if grad:
            p = steps.tree_map(lambda t: t.requires_grad_(True), p)
        got, got_aux, got_cache = transformer.forward(cfg, p, batch)
        hid, _, _ = transformer.forward(cfg, p, batch, return_hidden=True)
    assert got_cache is None and cache is None
    assert float(got_aux) == float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(
        (hid @ transformer.unembed_matrix(cfg, p)).detach().numpy(),
        np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    assert transformer.active_params(cfg, p) == \
        ref.active_params(_ref_cfg(cfg), pj)


def test_facade_matches_reference():
    cfg = _cfg()
    pj, p = _params(cfg)
    toks = _tokens(cfg, (2, 24))
    want, _, _ = load_reference().transformer.Transformer(
        _ref_cfg(cfg)).apply(pj, {"tokens": jnp.asarray(toks)})
    m = transformer.Transformer(cfg)
    got, _, _ = m.apply(p, {"tokens": torch.tensor(toks)}, remat=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=LOGIT_ATOL)
    _assert_trees_close(m.init(rng.PRNGKey(0), device="cpu"),
                        jax.tree.map(np.asarray, pj), 4e-7)
    moe_cfg = _cfg("qwen2-moe-a2.7b")
    pm, pt = _params(moe_cfg)
    assert transformer.active_params(moe_cfg, pt) == \
        load_reference().transformer.active_params(_ref_cfg(moe_cfg), pm)


CHUNK_CFG = dict(num_layers=2, d_model=128, num_heads=2, num_kv_heads=1,
                 head_dim=64, d_ff=256, vocab_size=512)


def test_chunked_attention_matches_reference():
    """masked_attention above CHUNKED_THRESHOLD at T = 2048 (4 query
    chunks, 2 key chunks), and with keys padded to a whole key chunk
    (S = 1536): outputs and the gradients in q, k and v."""
    ref = load_reference().attention
    g = np.random.default_rng(0)
    for T, S in ((2048, 2048), (1536, 1536)):
        q = g.standard_normal((1, T, 4, 64)).astype(np.float32)
        k = g.standard_normal((1, S, 2, 64)).astype(np.float32)
        v = g.standard_normal((1, S, 2, 64)).astype(np.float32)
        do = g.standard_normal((1, T, 4, 64)).astype(np.float32)
        pos = np.arange(T)[None]

        def ref_fn(q, k, v):
            o = ref.masked_attention(q, k, v, jnp.asarray(pos),
                                     jnp.asarray(pos[:, :S]), scale=0.125)
            return jnp.sum(o * do), o

        (_, want), gw = jax.value_and_grad(ref_fn, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
        qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        got = attention.masked_attention(
            qt, kt, vt, torch.tensor(pos), torch.tensor(pos[:, :S]),
            scale=0.125)
        gg = torch.autograd.grad((got * torch.tensor(do)).sum(),
                                 (qt, kt, vt))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=LOGIT_ATOL)
        for a, b in zip(gg, gw):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=LOGIT_ATOL)


def test_chunked_attention_refuses_a_ragged_query_chunk():
    """T = 1025 > CHUNKED_THRESHOLD is no multiple of Q_CHUNK: the
    reference asserts, the port raises (neither pads)."""
    q = torch.zeros(1, 1025, 2, 32)
    pos = torch.arange(1025)[None]
    with pytest.raises(ValueError, match="q-chunk"):
        attention.masked_attention(q, q[:, :, :1], q[:, :, :1], pos, pos,
                                   scale=1.0)
    with pytest.raises(AssertionError, match="q-chunk"):
        load_reference().attention.masked_attention(
            jnp.zeros((1, 1025, 2, 32)), jnp.zeros((1, 1025, 1, 32)),
            jnp.zeros((1, 1025, 1, 32)), jnp.asarray(pos.numpy()),
            jnp.asarray(pos.numpy()), scale=1.0)


def test_train_step_at_t2048_takes_the_chunked_branches():
    """One train step at T = 2048 on a 2-layer, head-dim-64 config: the
    chunked attention (4 query x 2 key chunks) and 4 loss chunks."""
    cfg = _cfg(**CHUNK_CFG)
    pj, p = _params(cfg)
    toks = _tokens(cfg, (1, 2048))
    want_p, want_m = jax.jit(load_reference().steps.make_train_step(
        _ref_cfg(cfg)))(pj, {"tokens": jnp.asarray(toks)})
    got_p, got_m = steps.make_train_step(cfg)(p, {"tokens":
                                                  torch.tensor(toks)})
    for k in ("loss", "ce", "kd"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=0, atol=LOSS_ATOL)
    _assert_trees_close(got_p, want_p, LOSS_ATOL)


# ---------------------------------------------------------------------------
# bucketing and the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V,nb,atol", [
    (512, 64, 1e-6), (500, 64, 1e-6), (10, 3, 1e-6),
    # qwen2-0.5b's vocab: logsumexps over blocks of 2374 logits in
    # another summation order, ~4 float32 ulps of |log p| ~ 4
    (151936, 64, 4e-6)])
def test_bucket_log_probs_match_reference(V, nb, atol):
    """With (V % nb != 0) and without vocab padding (the -1e30 pad)."""
    ref = load_reference().outputs
    lg = np.random.default_rng(V).standard_normal((2, 3, V)) \
        .astype(np.float32)
    want = ref.bucket_log_probs(jnp.asarray(lg), nb)
    got = outputs.bucket_log_probs(torch.tensor(lg), nb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)
    assert outputs.bucket_block(V, nb) == ref.bucket_block(V, nb)
    toks = np.random.default_rng(1).integers(0, V, (4, 7))
    np.testing.assert_array_equal(
        outputs.bucketize_tokens(torch.tensor(toks), V, nb).numpy(),
        np.asarray(ref.bucketize_tokens(jnp.asarray(toks), V, nb)))


def _gout(cfg, seed=2):
    g = np.random.default_rng(seed).random((cfg.fd_buckets,
                                            cfg.fd_buckets))
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("arch,S", [(a, 32) for a in ARCHS]
                         + [("qwen2-0.5b", 1024)])
def test_lm_loss_matches_reference(arch, S):
    """ce, kd and the loss of the KD-regularised loss (S 1024: two loss
    chunks; S 32: one)."""
    cfg = _cfg(arch)
    pj, p = _params(cfg)
    toks = _tokens(cfg, (2, S))
    gout = _gout(cfg)
    want, wparts = load_reference().steps._lm_loss(
        _ref_cfg(cfg), pj, {"tokens": jnp.asarray(toks),
                            "gout": jnp.asarray(gout)})
    got, gparts = steps._lm_loss(cfg, p, {"tokens": torch.tensor(toks),
                                          "gout": torch.tensor(gout)})
    np.testing.assert_allclose(float(got), float(want), rtol=0,
                               atol=LOSS_ATOL)
    for k in ("ce", "kd", "aux"):
        np.testing.assert_allclose(float(gparts[k]), float(wparts[k]),
                                   rtol=0, atol=LOSS_ATOL)
    assert float(gparts["kd"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One SGD step on the KD loss: metrics within 1e-5 and every updated
    parameter within 1e-5 (zamba2: the hybrid train step)."""
    cfg = _cfg(arch)
    pj, p = _params(cfg)
    toks = _tokens(cfg, (2, 48))
    gout = _gout(cfg)
    want_p, want_m = jax.jit(load_reference().steps.make_train_step(
        _ref_cfg(cfg)))(pj, {"tokens": jnp.asarray(toks),
                             "gout": jnp.asarray(gout)})
    before = [t.clone() for t in steps.tree_leaves(p)]
    got_p, got_m = steps.make_train_step(cfg)(
        p, {"tokens": torch.tensor(toks), "gout": torch.tensor(gout)})
    for k in ("loss", "ce", "kd", "aux"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=0, atol=LOSS_ATOL)
    _assert_trees_close(got_p, want_p, LOSS_ATOL)
    # out of place: the given parameters are unchanged
    for a, b in zip(before, steps.tree_leaves(p)):
        assert torch.equal(a, b)


def test_grad_accum_matches_single_batch():
    """tests/test_steps.py:45 (grad_accum 2 against 1, loss rtol 1e-5,
    parameters atol 1e-5), and each against the reference."""
    cfg = _cfg()
    pj, p = _params(cfg)
    toks = _tokens(cfg, (4, 32))
    ref = load_reference().steps
    got, want = {}, {}
    for accum in (1, 2):
        want[accum] = jax.jit(ref.make_train_step(
            _ref_cfg(cfg), grad_accum=accum))(pj,
                                              {"tokens": jnp.asarray(toks)})
        got[accum] = steps.make_train_step(cfg, grad_accum=accum)(
            p, {"tokens": torch.tensor(toks)})
        np.testing.assert_allclose(float(got[accum][1]["loss"]),
                                   float(want[accum][1]["loss"]), rtol=0,
                                   atol=LOSS_ATOL)
        _assert_trees_close(got[accum][0], want[accum][0], LOSS_ATOL)
    np.testing.assert_allclose(float(got[1][1]["loss"]),
                               float(got[2][1]["loss"]), rtol=1e-5)
    _assert_trees_close(got[1][0], got[2][0], 1e-5)


def test_accum_dtype_sets_the_accumulators():
    cfg = _cfg()
    _, p = _params(cfg)
    toks = torch.tensor(_tokens(cfg, (4, 16)))
    base = steps.make_train_step(cfg, grad_accum=2)(p, {"tokens": toks})
    steps.set_accum_dtype(torch.float64)
    try:
        wide = steps.make_train_step(cfg, grad_accum=2)(p, {"tokens": toks})
    finally:
        steps.set_accum_dtype(torch.float32)
    _assert_trees_close(wide[0], base[0], 1e-6)
    for t in steps.tree_leaves(wide[0]):
        assert t.dtype == torch.float32


# ---------------------------------------------------------------------------
# bfloat16: the order of the full-width path (qwen2-0.5b's param_dtype)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gdt", [jnp.float32, jnp.bfloat16],
                         ids=["f32_grads", "bf16_grads"])
def test_bf16_sgd_update_matches_reference(gdt):
    """The train step's update ``p - lr * g.astype(p.dtype)`` on
    bfloat16 parameters, with the float32 accumulated gradients of a
    grad_accum step and the bfloat16 gradients of a single step: bit
    for bit with the reference's ``optim.sgd`` (the same expression as
    its ``make_train_step``).  jax rounds the Python ``lr`` to bfloat16
    before the product; a float32 ``lr`` rounded once changes ~7% of
    the elements."""
    g = np.random.default_rng(0)
    p = (g.standard_normal((512, 256)) * 0.1).astype(np.float32)
    gr = (g.standard_normal((512, 256)) * 3).astype(np.float32)
    pj, grj = jnp.asarray(p, jnp.bfloat16), jnp.asarray(gr, gdt)
    ref = load_reference().optim.sgd(0.01)
    want = jax.jit(lambda g_, p_: ref.update(g_, ref.init(p_), p_)[0])(
        {"w": grj}, {"w": pj})["w"]
    opt = optim.sgd(0.01)
    pt = {"w": torch.tensor(p).bfloat16()}
    gt = {"w": torch.tensor(np.asarray(grj.astype(jnp.float32))).to(
        torch.float32 if gdt == jnp.float32 else torch.bfloat16)}
    got = opt.update(gt, opt.init(pt), pt)[0]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_bf16_chunk_losses_match_reference():
    """The loss chunk on bfloat16 hidden states and unembedding: the
    logits are the bfloat16 product, then float32, as the reference's
    ``(h @ W).astype(f32)``: ce and kd within 1e-6 relative (a float32
    product instead moves ce by ~3e-5)."""
    cfg = _cfg(param_dtype="bfloat16")
    g = np.random.default_rng(3)
    h = g.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    W = (g.standard_normal((cfg.d_model, cfg.vocab_size)) * 0.05) \
        .astype(np.float32)
    tgt = g.integers(0, cfg.vocab_size, (2, 48))
    msk = np.ones((2, 48), np.float32)
    gout = _gout(cfg)
    want = jax.jit(functools.partial(load_reference().steps._chunk_losses,
                                     _ref_cfg(cfg)))(
        jnp.asarray(W, jnp.bfloat16), jnp.asarray(gout),
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(tgt), jnp.asarray(msk))
    got = steps._chunk_losses(cfg, torch.tensor(W).bfloat16(),
                              torch.tensor(gout), torch.tensor(h).bfloat16(),
                              torch.tensor(tgt), torch.tensor(msk))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_bf16_train_step_matches_reference(accum):
    """One train step, and one grad_accum-2 step, on the qwen2 smoke
    config in bfloat16 at S 1024 (two loss chunks), against the
    reference's jitted ``make_train_step``.  Both round every op to
    bfloat16 but in another order (fused in XLA), so their bf16
    gradients differ by ~1-2% of a leaf's largest (2-3 bf16 ulps).
    Bounds: the float32 losses within 1e-4 relative (measured 4e-6);
    each parameter within one bf16 ulp of itself plus 2^-5 of the
    leaf's largest step (measured up to 0.021 of it); every leaf stays
    bfloat16 and untouched leaves stay equal."""
    cfg = _cfg(param_dtype="bfloat16")
    pj, p = _params(cfg)
    toks = _tokens(cfg, (4, 1024))
    gout = _gout(cfg)
    want_p, want_m = jax.jit(load_reference().steps.make_train_step(
        _ref_cfg(cfg), grad_accum=accum))(
        pj, {"tokens": jnp.asarray(toks), "gout": jnp.asarray(gout)})
    got_p, got_m = steps.make_train_step(cfg, grad_accum=accum)(
        p, {"tokens": torch.tensor(toks), "gout": torch.tensor(gout)})
    for k in ("loss", "ce", "kd"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-4)
    assert all(t.dtype == torch.bfloat16 for t in steps.tree_leaves(got_p))
    moved = 0
    for a, b, q in zip(_leaves(got_p), _leaves(want_p),
                       _leaves(jax.tree.map(np.asarray, pj))):
        top = np.abs(b - q).max()
        if top == 0:
            np.testing.assert_array_equal(a, b)
            continue
        moved += 1
        m = np.maximum(np.abs(a), np.abs(b))
        ulp = np.exp2(np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
        assert (np.abs(a - b) <= ulp + 2.0 ** -5 * top).all()
    assert moved >= 10


# ---------------------------------------------------------------------------
# the federated LM steps
# ---------------------------------------------------------------------------

def _pods(pj, n, scale=None):
    return jax.tree.map(lambda a: jnp.stack(
        [a] * n if scale is None else [a, scale * a.astype(jnp.float32)]
    ).astype(a.dtype), pj)


def _port(cfg, tree):
    return transformer.params_from_jax(cfg, jax.tree.map(np.asarray, tree),
                                       "cpu")


def test_fd_sync_step_converts_and_broadcasts():
    """tests/test_steps.py:61: gout is the pods' mean (rtol 1e-6), every
    pod's replica equal after the conversion, and the conversion moved
    the weights; against the reference within 1e-5."""
    cfg = _cfg()
    n_pods = 2
    pj, p = _params(cfg)
    pod_in = _pods(pj, n_pods)
    favg = np.asarray(jax.nn.softmax(jax.random.normal(
        jax.random.PRNGKey(2), (n_pods, cfg.fd_buckets, cfg.fd_buckets)),
        axis=-1))
    toks = _tokens(cfg, (4, 32), seed=3)
    want_p, want_g = jax.jit(load_reference().steps.make_fd_sync_step(
        _ref_cfg(cfg), n_pods, ks_iters=2))(
        pod_in, jnp.asarray(favg), {"tokens": jnp.asarray(toks)})
    got_p, got_g = steps.make_fd_sync_step(cfg, n_pods, ks_iters=2)(
        _port(cfg, pod_in), torch.tensor(favg),
        {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(got_g.numpy(), favg.mean(0), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6)
    _assert_trees_close(got_p, want_p, LOSS_ATOL)
    for leaf in steps.tree_leaves(got_p):
        assert leaf.shape[0] == n_pods
        np.testing.assert_allclose(leaf[0].numpy(), leaf[1].numpy())
    assert any(not np.allclose(a[0], b) for a, b in
               zip(_leaves(got_p), _leaves(jax.tree.map(np.asarray, pj))))


def test_fl_sync_step_averages_pods():
    """tests/test_steps.py:88: pods p and 3p average to 2p (rtol 2e-2,
    atol 1e-4) on every pod; against the reference bit for bit."""
    cfg = _cfg()
    pj, _ = _params(cfg)
    pod_in = _pods(pj, 2, scale=3.0)
    want = jax.jit(load_reference().steps.make_fl_sync_step(
        _ref_cfg(cfg), 2))(pod_in)
    got = steps.make_fl_sync_step(cfg, 2)(_port(cfg, pod_in))
    _assert_trees_close(got, want, 1e-6)
    for o, q in zip(_leaves(got), _leaves(jax.tree.map(np.asarray, pj))):
        np.testing.assert_allclose(o[0], 2.0 * q, rtol=2e-2, atol=1e-4)
        np.testing.assert_allclose(o[0], o[1])


def test_local_train_step_keeps_pods_independent():
    """tests/test_steps.py:104: different pod data give different pod
    parameters, one loss a pod; against the reference within 1e-5; the
    given stack is unchanged (updates are out of place)."""
    cfg = _cfg()
    n_pods = 2
    pj, _ = _params(cfg)
    pod_in = _pods(pj, n_pods)
    toks = _tokens(cfg, (n_pods, 4, 32))
    want_p, want_m = jax.jit(load_reference().steps.make_local_train_step(
        _ref_cfg(cfg), n_pods))(pod_in, {"tokens": jnp.asarray(toks)})
    stack = _port(cfg, pod_in)
    before = [t.clone() for t in steps.tree_leaves(stack)]
    got_p, got_m = steps.make_local_train_step(cfg, n_pods)(
        stack, {"tokens": torch.tensor(toks)})
    assert got_m["loss"].shape == (n_pods,)
    np.testing.assert_allclose(got_m["loss"].numpy(),
                               np.asarray(want_m["loss"]), rtol=0,
                               atol=LOSS_ATOL)
    _assert_trees_close(got_p, want_p, LOSS_ATOL)
    assert any(not np.allclose(a[0], a[1]) for a in _leaves(got_p))
    for a, b in zip(before, steps.tree_leaves(stack)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_favg_step_rows_are_distributions(arch):
    """tests/test_steps.py:123: an (NB, NB) table whose non-empty rows
    sum to 1 (atol 1e-4); against the reference within 1e-4.  It records
    no gradient, so on the GPU its forward takes the kernels."""
    cfg = _cfg(arch)
    pj, p = _params(cfg)
    toks = _tokens(cfg, (4, 64))
    want = jax.jit(load_reference().steps.make_favg_step(_ref_cfg(cfg)))(
        pj, {"tokens": jnp.asarray(toks)})
    p = steps.tree_map(lambda t: t.requires_grad_(True), p)
    got = steps.make_favg_step(cfg)(p, {"tokens": torch.tensor(toks)})
    assert not got.requires_grad
    assert got.shape == (cfg.fd_buckets, cfg.fd_buckets)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    sums = got.sum(-1).numpy()
    nz = sums > 0
    np.testing.assert_allclose(sums[nz], 1.0, atol=1e-4)


def test_shardmap_sync_waits_for_a13():
    with pytest.raises(NotImplementedError, match="A13"):
        steps.make_fd_sync_step_shardmap(_cfg(), None)
