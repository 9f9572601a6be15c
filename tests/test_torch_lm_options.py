"""Options of the LM configs that the port once refused (M-RoPE,
cross-attention, the int8 cache, MLA and the hybrid's int8 cache, on
the smoke configs), each held to the reference on the CPU: the same
``init_params`` leaves (within 4 float32 ulps), ``cache_shapes`` and the
no-cache forward (logits within 1e-4).

Moved out of ``tests/test_torch_lm.py`` so that a test worker takes it
apart from that file: most of its time is the weight draws of both
sides.  One torch intra-op thread (the port's threefry draws of the
MoE experts are elementwise int64 passes that many threads slow down on
a shared machine).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.models import kvcache, transformer
from test_torch_lm import LOGIT_ATOL, SMOKE, _cfg, _np, _ref_cfg, \
    _ref_params
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _no_cache_forward(cfg, params, batch, port):
    """The no-cache forward of the port (``port``) or the reference on a
    numpy batch: float32 logits, or the exception's type."""
    try:
        if port:
            return _np(transformer.forward(
                cfg, params, {k: torch.tensor(v) for k, v in batch.items()})[0])
        return np.asarray(load_reference().transformer.forward(
            _ref_cfg(cfg), params,
            {k: jnp.asarray(v) for k, v in batch.items()})[0])
    except (KeyError, ValueError) as e:
        return type(e)


@pytest.mark.parametrize("name,change", [
    # the options the port refused until M-RoPE, cross-attention and the
    # int8 cache were ported (A15-arch part 3), on this file's smoke
    # config, and MLA's and the hybrid's on theirs (MLA with M-RoPE runs
    # as plain MLA, as in the reference)
    ("deepseek-v2-236b-smoke", dict(attn_type="mla", mrope=True)),
    ("deepseek-v2-236b-smoke", dict(family="moe", attn_type="mla",
                                    cross_attention=True)),
    ("zamba2-2.7b-smoke", dict(family="hybrid", kv_quant=True)),
    (SMOKE, dict(family="vlm")), (SMOKE, dict(family="audio")),
    (SMOKE, dict(kv_quant=True)), (SMOKE, dict(cross_attention=True)),
    (SMOKE, dict(mrope=True)),
    (SMOKE, dict(embed_input=True, mrope=True)),
    (SMOKE, dict(qk_norm=True, kv_quant=True)),
    (SMOKE, dict(pos_emb="learned", cross_attention=True)),
], ids=[f"change{i}" for i in range(11)])
def test_options_outside_the_slice_match_reference(name, change):
    """Each option the port once refused is held to the reference: ``init_params`` (the same leaves within 4
    float32 ulps), ``cache_shapes`` and the no-cache forward (logits
    within 1e-4; MLA with cross-attention has no cross weights in either,
    so both forwards fail alike)."""
    ref = load_reference()
    cfg = _cfg(name, **change)
    rcfg = _ref_cfg(cfg)
    want = _ref_params(cfg)
    got = transformer.init_params(cfg, rng.PRNGKey(0), device="cpu")
    assert [p for p, _ in _paths(got)] == [p for p, _ in _paths(want)]
    for path, w in _paths(want):
        g = got
        for k in path:
            g = g[k]
        np.testing.assert_allclose(_np(g), w, rtol=4 * 2.0 ** -23,
                                   atol=1e-30, err_msg=str(path))
    shapes = kvcache.cache_shapes(cfg, 2, 8)
    want_shapes = ref.kvcache.cache_shapes(rcfg, 2, 8)
    assert [p for p, _ in _paths(shapes)] == \
        [p for p, _ in _paths(want_shapes)]
    for (path, (shape, dtype)), (_, (w_shape, w_dtype)) in zip(
            _paths({k: v for k, v in shapes.items() if k != "pos"}),
            _paths({k: v for k, v in want_shapes.items() if k != "pos"})):
        assert shape == w_shape and str(dtype).removeprefix("torch.") == \
            jnp.dtype(w_dtype).name, path
    rs = np.random.default_rng(len(change))
    batch = ({"embeds": rs.standard_normal((1, 8, cfg.d_model)).astype(
        np.float32)} if cfg.embed_input
        else {"tokens": rs.integers(0, cfg.vocab_size, (1, 8))})
    if cfg.cross_attention:
        batch["enc_out"] = (0.1 * rs.standard_normal(
            (1, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    ours = _no_cache_forward(cfg, transformer.params_from_jax(
        cfg, want, device="cpu"), batch, port=True)
    theirs = _no_cache_forward(cfg, want, batch, port=False)
    if isinstance(theirs, type):
        assert ours is theirs
    else:
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=LOGIT_ATOL)
