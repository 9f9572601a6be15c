"""The port's vlm family (qwen2-vl-72b: M-RoPE, embedding inputs, GQA
64/8 with QKV bias) against the reference, on the CPU: the config and its
card preset, init and the weight bridge, ``mrope_cos_sin``,
``gqa_attention`` with ``positions3``, the cache, prefill then decode
with embeddings, ``make_prefill_step`` with ``"embeds"``, the serve's
refusal, the no-cache forward, one train step and the favg step.

Config: the smoke preset (float32, 2 layers, 4 query heads over 2 KV
heads of 32, d_model 256, M-RoPE sections 4/6/6 of the half head dim
16).  Weights are the reference's ``init_params`` tree carried across by
``params_from_jax`` (and, for the init itself, drawn by both from the
same key); embeddings and labels are drawn from a seed with numpy.
Tolerances: logits and cache leaves within 1e-4 (float32 on both sides,
another summation order), an attention layer within 1e-5 in float32 and
2 bf16 ulps of the output's scale in bf16, one SGD step within 1e-5,
init within 4 float32 ulps.  M-RoPE's angles within two float32 ulps
and its cos and sin within one: XLA's and PyTorch's pow, cos and sin
differ in the last bit for some arguments.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs, rng
from repro_torch.configs import qwen2_vl_72b
from repro_torch.launch import serve as port_serve
from repro_torch.launch import steps
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention, kvcache, rope, transformer
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401

ARCH = "qwen2-vl-72b"
ATOL = 1e-4
F32_ATOL = 1e-5
ULP = 2.0 ** -23   # one float32 ulp at 1


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


def _embeds(cfg, shape, seed):
    """Stub embeddings as the reference's tests make them: normal x 0.1."""
    return (0.1 * np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,))).astype(np.float32)


def _labels(cfg, shape, seed):
    return np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, shape)


def _both(batch):
    """A numpy batch as the reference's and the port's inputs."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.tensor(v) for k, v in batch.items()})


def _meta_count(cfg):
    """The reference's parameter count at ``cfg`` (shapes only) and the
    port's count of the same shapes."""
    ref = load_reference().transformer
    shapes = jax.eval_shape(lambda: ref.init_params(
        _ref_cfg(cfg), jax.random.PRNGKey(0)))
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        shapes)
    return (ref.count_params(shapes), transformer.count_params(meta),
            ref.active_params(_ref_cfg(cfg), shapes),
            transformer.active_params(cfg, meta))


# ---------------------------------------------------------------------------
# the config and its card preset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_match_reference(smoke):
    ref = load_reference()
    assert ARCH in configs.list_archs()
    name = ARCH + ("-smoke" if smoke else "")
    mine, theirs = configs.get_config(name), ref.configs.get_config(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.family == "vlm" and mine.mrope and mine.embed_input


def test_card_preset_keeps_the_published_widths():
    """8 of 80 layers at the published widths: 877,684,736 parameters a
    layer and 1,245,716,480 in the unembedding and final norm, so
    8,267,194,368 (the port's count of the reference's shapes); all 80
    layers are 71,460,495,360."""
    full, card = configs.get_config(ARCH), qwen2_vl_72b.card()
    assert card.num_layers == qwen2_vl_72b.CARD_LAYERS == 8
    assert dataclasses.replace(card, num_layers=80) == full
    for cfg, want in ((card, 8267194368), (full, 71460495360)):
        n_ref, n, a_ref, a = _meta_count(cfg)
        assert n == n_ref == a == a_ref == want
        assert want == 1245716480 + cfg.num_layers * 877684736


def test_init_params_match_reference():
    """Embedding inputs: no embedding table, an unembedding; the GQA
    leaves with their biases; every leaf within 4 float32 ulps."""
    ref = load_reference()
    cfg = _cfg()
    want = _ref_params(cfg)
    got = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    assert "embed" not in got and "unembed" in got
    assert set(got["blocks"]["attn"]) == {"wq", "wk", "wv", "wo", "bq",
                                          "bk", "bv"}
    assert transformer.count_params(got) == \
        ref.transformer.count_params(want)
    for path, w in _leaves(want):
        g = _get(got, path)
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, rtol=4 * ULP, atol=1e-30,
                                   err_msg=str(path))


def test_params_from_jax_gives_the_same_forward():
    cfg = _cfg()
    emb = torch.tensor(_embeds(cfg, (2, 40), 3))
    outs = [make_prefill_step(cfg, 44)(params, {"embeds": emb})[0]
            for params in (transformer.init_params(cfg, rng.PRNGKey(0),
                                                   device="cpu"),
                           transformer.params_from_jax(cfg, _ref_params(cfg),
                                                       device="cpu"))]
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=0,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

class _AngleOf:
    """A stand-in for a module's array namespace whose cos and sin
    return their argument: the rope function then returns its angles."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    @staticmethod
    def cos(a):
        return a

    @staticmethod
    def sin(a):
        return a


@pytest.mark.parametrize("head_dim,theta,hi", [(32, 1e4, 64),
                                               (128, 1e6, 1100),
                                               (64, 1e4, 4096)])
def test_mrope_matches_reference(monkeypatch, head_dim, theta, hi):
    """Distinct (t, h, w) streams (sections 4/6/6, 16/24/24 and 8/12/12
    of the half dim): the angles within two float32 ulps of the
    reference's (XLA's and PyTorch's pow differ in the last bit of a few
    inverse frequencies at theta 1e6, and the product with the position
    rounds once more; at 1e4 the angles are equal) and cos and sin
    within one float32 ulp."""
    ref = load_reference()
    pos3 = np.random.default_rng(head_dim).integers(0, hi, (2, 9, 3))
    pj, pt = jnp.asarray(pos3, jnp.int32), torch.tensor(pos3)
    cj, sj = ref.rope.mrope_cos_sin(pj, head_dim, theta)
    ct, st = rope.mrope_cos_sin(pt, head_dim, theta)
    assert ct.dtype == torch.float32 and ct.shape == (2, 9, head_dim // 2)
    for got, want in ((ct, cj), (st, sj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ULP)
    monkeypatch.setattr(ref.rope, "jnp", _AngleOf(jnp))
    monkeypatch.setattr(rope, "torch", _AngleOf(torch))
    ang_j = np.asarray(ref.rope.mrope_cos_sin(pj, head_dim, theta)[0])
    ang_t = rope.mrope_cos_sin(pt, head_dim, theta)[0].numpy()
    np.testing.assert_allclose(ang_t, ang_j, rtol=2 * ULP, atol=0)
    if theta == 1e4:
        np.testing.assert_array_equal(ang_t, ang_j)
    # each section reads its own stream
    half = head_dim // 2
    a, b = round(0.25 * half), round(0.375 * half)
    for sec, cols in enumerate((slice(0, a), slice(a, a + b),
                                slice(a + b, half))):
        inv = ang_t[..., cols] / np.maximum(pos3[..., sec:sec + 1], 1)
        assert np.allclose(inv[pos3[..., sec] > 0],
                           inv[pos3[..., sec] > 0][0], rtol=1e-6)


@pytest.mark.parametrize("head_dim,theta", [(32, 1e4), (128, 1e6)])
def test_mrope_of_identical_streams_is_rope(head_dim, theta):
    pos = torch.tensor(np.random.default_rng(1).integers(0, 5000, (3, 17)))
    got = rope.mrope_cos_sin(torch.stack([pos] * 3, -1), head_dim, theta)
    want = rope.rope_cos_sin(pos, head_dim, theta)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# one attention layer, the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_cache", [False, True],
                         ids=["prompt", "decode"])
def test_gqa_attention_with_positions3_matches_reference(with_cache, dtype):
    """One layer with non-zero biases and distinct (t, h, w) streams:
    the prompt (T 24 into a 32-slot cache) and one decode step at
    position 8 of a 16-slot cache whose first 8 slots hold keys.
    float32 within 1e-5, bf16 within 2 bf16 ulps of the output's scale;
    the written k and v as close."""
    ref = load_reference()
    cfg = _cfg(param_dtype=dtype)
    rcfg = _ref_cfg(cfg)
    rs = np.random.default_rng(4)
    pj = jax.tree.map(np.asarray, ref.attention.init_attn(
        rcfg, jax.random.PRNGKey(4)))
    for b in ("bq", "bk", "bv"):
        pj[b] = (0.1 * rs.standard_normal(pj[b].shape)).astype(pj[b].dtype)
    pt = transformer.params_from_jax(None, pj, "cpu")
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    B, T, S = 2, (1 if with_cache else 24), (16 if with_cache else 32)
    x = rs.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(8, 8 + T) if with_cache
                            else np.arange(T), (B, T)).astype(np.int32)
    pos3 = np.stack([q_pos, q_pos // 2, q_pos % 5], -1).astype(np.int32)
    kv_pos = q_pos
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
    kv = {k: np.zeros(shape, np.float32) for k in ("k", "v")}
    if with_cache:
        kv_pos = np.broadcast_to(np.where(np.arange(S) <= 8, np.arange(S),
                                          -1), (B, S)).astype(np.int32)
        for a in kv.values():
            a[:, :8] = rs.standard_normal(a[:, :8].shape)
    cj = {k: jnp.asarray(a, jdt) for k, a in kv.items()}
    ct = {k: torch.tensor(a).to(tdt) for k, a in kv.items()}
    oj, new_cj = ref.attention.gqa_attention(
        rcfg, jax.tree.map(jnp.asarray, pj), jnp.asarray(x, jdt),
        jnp.asarray(q_pos), jnp.asarray(kv_pos), cj, jnp.asarray(pos3))
    with torch.no_grad():
        ot, new_ct = attention.gqa_attention(
            cfg, pt, torch.tensor(x).to(tdt), torch.tensor(q_pos),
            torch.tensor(kv_pos), ct, torch.tensor(pos3))
    assert new_ct is ct and ot.dtype == tdt
    oj = np.asarray(oj, np.float32)
    scale = 2 * 2.0 ** -8
    atol = F32_ATOL if dtype == "float32" else scale * np.abs(oj).max()
    np.testing.assert_allclose(ot.float().numpy(), oj, rtol=0, atol=atol)
    for k in ("k", "v"):
        want = np.asarray(new_cj[k], np.float32)
        atol = F32_ATOL if dtype == "float32" else scale * np.abs(want).max()
        np.testing.assert_allclose(ct[k].float().numpy(), want, rtol=0,
                                   atol=atol, err_msg=k)


def test_gqa_attention_needs_positions3_for_mrope():
    cfg = _cfg()
    p = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    p = {k: t[0] for k, t in p["blocks"]["attn"].items()}
    pos = torch.arange(3)[None]
    with pytest.raises(ValueError, match="positions3"):
        attention.gqa_attention(cfg, p, torch.zeros(1, 3, cfg.d_model), pos,
                                pos)


@pytest.mark.parametrize("name", [ARCH, ARCH + "-smoke"])
def test_cache_shapes_match_reference(name):
    """The dense cache: (L, B, Sc, Hkv, hd) k and v in the parameters'
    dtype; (80, 4, 1056, 8, 128) at full width, batch 4 and 1056
    positions (phase 38's)."""
    ref = load_reference()
    cfg = configs.get_config(name)
    want = ref.kvcache.cache_shapes(_ref_cfg(cfg), 4, 1056)
    got = kvcache.cache_shapes(cfg, 4, 1056)
    assert set(got) == set(want) == {"pos", "layers"}
    assert set(got["layers"]) == set(want["layers"]) == {"k", "v"}
    for k, (shape, dtype) in got["layers"].items():
        assert shape == want["layers"][k][0], k
        assert str(dtype).removeprefix("torch.") == \
            jnp.dtype(want["layers"][k][1]).name
    if name == ARCH:
        assert got["layers"]["k"][0] == (80, 4, 1056, 8, 128)


# ---------------------------------------------------------------------------
# prefill, decode
# ---------------------------------------------------------------------------

def test_prefill_then_decode_matches_reference():
    """B 1, S 160 embeddings (tests/test_models.py's prefill-then-decode
    case): the prefill of 160 and one decode step, against the
    reference's full forward over 161 (relative 5e-3, as there) and the
    reference's own prefill and decode: logits and cache within 1e-4."""
    ref = load_reference()
    cfg = _cfg()
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=1)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    S = 160
    emb = _embeds(cfg, (1, S + 1), 1)
    full = np.asarray(ref.transformer.forward(
        rcfg, pj, {"embeds": jnp.asarray(emb)})[0])
    scale = np.abs(full).max()
    cache = kvcache.init_cache(cfg, 1, S + 1, device="cpu")
    cj = ref.kvcache.init_cache(rcfg, 1, S + 1)
    for sl in (slice(0, S), slice(S, S + 1)):
        got, _, cache = transformer.forward(
            cfg, pt, {"embeds": torch.tensor(emb[:, sl])}, cache=cache)
        want, _, cj = ref.transformer.forward(
            rcfg, pj, {"embeds": jnp.asarray(emb[:, sl])}, cache=cj)
        assert np.abs(got.numpy() - full[:, sl]).max() / scale < 5e-3
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    assert cache["pos"] == int(cj["pos"]) == S + 1
    for k in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][k].numpy(),
                                   np.asarray(cj["layers"][k]), rtol=0,
                                   atol=ATOL, err_msg=k)


def test_prefill_and_decode_steps_match_reference():
    """``make_prefill_step`` with ``"embeds"`` (prompt 40 into 43 slots)
    against the reference's jitted step, then three decode steps, each
    fed the next stub embedding: last-token logits within 1e-4, greedy
    tokens equal."""
    ref = load_reference()
    cfg = _cfg()
    rcfg = _ref_cfg(cfg)
    pj = _ref_params(cfg, seed=2)
    pt = transformer.params_from_jax(cfg, pj, device="cpu")
    prompt, total = 40, 43
    emb = _embeds(cfg, (2, total), 2)
    lj, cj = jax.jit(ref.steps.make_prefill_step(rcfg, total))(
        pj, {"embeds": jnp.asarray(emb[:, :prompt])})
    lt, ct = make_prefill_step(cfg, total)(
        pt, {"embeds": torch.tensor(emb[:, :prompt])})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=ATOL)
    dec_j = jax.jit(ref.steps.make_decode_step(rcfg))
    dec_t = make_decode_step(cfg)
    toks_j, toks_t = [jnp.argmax(lj, -1)], [torch.argmax(lt, -1)]
    for t in range(prompt, total):
        nj, cj = dec_j(pj, {"embeds": jnp.asarray(emb[:, t:t + 1]),
                            "cache": cj})
        nt, ct = dec_t(pt, {"embeds": torch.tensor(emb[:, t:t + 1]),
                            "cache": ct})
        toks_j.append(nj)
        toks_t.append(nt)
    np.testing.assert_array_equal(torch.stack(toks_t, 1).numpy(),
                                  np.asarray(jnp.stack(toks_j, 1)))
    assert ct["pos"] == int(cj["pos"]) == total
    for k in ("k", "v"):
        np.testing.assert_allclose(ct["layers"][k].numpy(),
                                   np.asarray(cj["layers"][k]), rtol=0,
                                   atol=ATOL, err_msg=k)


def test_serve_refuses_embedding_archs_as_the_reference():
    ref = load_reference()
    with pytest.raises(SystemExit) as want:
        ref.serve.serve(ARCH, 2, 8, 2, smoke=True, log=lambda _: None)
    with pytest.raises(SystemExit) as got:
        port_serve.serve(ARCH, 2, 8, 2, smoke=True, log=lambda _: None,
                         device="cpu")
    assert str(got.value) == str(want.value)


def test_prefill_goes_through_the_kernel_module(monkeypatch):
    """The prefill calls flash attention once a layer at (B, T, H, hd)
    q, the two KV heads at their own heads for the four query heads (not
    repeated), no window."""
    cfg = _cfg()
    seen = []
    flash = attention.flash_attention_heads

    def spy(q, k, v, window=None, k_shared=None):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                     window))
        return flash(q, k, v, window, k_shared)

    monkeypatch.setattr(attention, "flash_attention_heads", spy)
    params = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    make_prefill_step(cfg, 44)(params, {"embeds": torch.tensor(
        _embeds(cfg, (2, 40), 0))})
    assert seen == [((2, 40, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32),
                     None)] * 2


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_no_cache_forward_matches_reference(grad):
    """The training forward over embeddings: without a gradient through
    flash attention's plain version, with one through
    ``masked_attention``; logits within 1e-4."""
    ref = load_reference()
    cfg = _cfg()
    pj = _ref_params(cfg, seed=7)
    p = transformer.params_from_jax(cfg, pj, "cpu")
    emb = _embeds(cfg, (2, 64), 7)
    want, _, _ = ref.transformer.forward(_ref_cfg(cfg), pj,
                                         {"embeds": jnp.asarray(emb)})
    with torch.set_grad_enabled(grad):
        if grad:
            p = steps.tree_map(lambda t: t.requires_grad_(True), p)
        got, _, cache = transformer.forward(cfg, p,
                                            {"embeds": torch.tensor(emb)})
    assert cache is None and got.requires_grad == grad
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


def test_train_step_matches_reference():
    """One SGD step on the KD loss over embeddings and labels: loss, ce
    and kd within 1e-5, every updated parameter within 1e-5."""
    ref = load_reference()
    cfg = _cfg()
    pj = _ref_params(cfg, seed=0)
    p = transformer.params_from_jax(cfg, pj, "cpu")
    g = np.random.default_rng(2).random((cfg.fd_buckets, cfg.fd_buckets))
    batch = {"embeds": _embeds(cfg, (2, 64), 1),
             "labels": _labels(cfg, (2, 64), 1),
             "gout": (g / g.sum(-1, keepdims=True)).astype(np.float32)}
    bj, bt = _both(batch)
    want_p, want_m = jax.jit(ref.steps.make_train_step(_ref_cfg(cfg)))(pj, bj)
    got_p, got_m = steps.make_train_step(cfg)(p, bt)
    for k in ("loss", "ce", "kd"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=0, atol=F32_ATOL)
    for path, w in _leaves(jax.tree.map(np.asarray, want_p)):
        np.testing.assert_allclose(_get(got_p, path).numpy(), w, rtol=0,
                                   atol=F32_ATOL, err_msg=str(path))


def test_favg_step_matches_reference():
    """The no-grad favg table over embeddings and labels: within 1e-5 of
    the reference's, its non-empty rows distributions."""
    ref = load_reference()
    cfg = _cfg()
    pj = _ref_params(cfg, seed=8)
    p = transformer.params_from_jax(cfg, pj, "cpu")
    bj, bt = _both({"embeds": _embeds(cfg, (4, 64), 8),
                    "labels": _labels(cfg, (4, 64), 8)})
    want = jax.jit(ref.steps.make_favg_step(_ref_cfg(cfg)))(pj, bj)
    got = steps.make_favg_step(cfg)(p, bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)
    sums = got.sum(-1).numpy()
    np.testing.assert_allclose(sums[sums > 0], 1.0, atol=1e-4)
