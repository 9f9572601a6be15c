"""Architecture assembly of the dense and SSM families: init,
cache-building prefill and single-token decode.

Parameters are a nested dict of tensors with the reference's tree and
layouts: every block leaf is stacked on a leading layer axis ``(L, ...)``
and dense weights are ``(in, out)`` applied as ``x @ W``.  The layers run
as a Python loop over that axis (the reference's ``lax.scan``).

What waits for later slices (ROADMAP A15): the no-cache forward and the
training step, the MoE, MLA, hybrid, vlm and audio families, learned
positions and embedding inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import rng
from ..device import resolve_device
from . import kvcache
from .attention import check_supported, gqa_attention, init_attn
from .layers import apply_norm, dtype_of, embed_init, init_norm
from .mamba2 import init_mamba, mamba2_forward
from .mlp import init_mlp, mlp
from .shardhooks import constrain


def _check(cfg) -> None:
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP A15")
    if cfg.embed_input:
        raise NotImplementedError(
            "embedding inputs (embed_input) are not ported yet: ROADMAP A15")
    if cfg.family == "dense":
        check_supported(cfg)
    elif cfg.pos_emb != "rope":
        raise NotImplementedError(
            f"pos_emb={cfg.pos_emb!r} is not ported yet: ROADMAP A15")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(cfg, key):
    ks = rng.split(key, 4).unbind(0)
    dev = key.device
    return {"ln1": init_norm(cfg, cfg.d_model, dev),
            "ln2": init_norm(cfg, cfg.d_model, dev),
            "attn": init_attn(cfg, ks[0]),
            "mlp": init_mlp(cfg, ks[1])}


def _init_mamba_block(cfg, key):
    return {"ln": init_norm(cfg, cfg.d_model, key.device),
            "mamba": init_mamba(cfg, key)}


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_params(cfg, key, device=None):
    """The reference's ``init_params(cfg, key)`` on ``device`` (default:
    the GPU).  Same key, same weights (normals within 4 float32 ulps)."""
    _check(cfg)
    key = key.to(resolve_device(device))
    ks = rng.split(key, 8).unbind(0)
    dt = dtype_of(cfg)
    p = {"final_norm": init_norm(cfg, cfg.d_model, key.device),
         "embed": embed_init(ks[0], cfg.vocab_size, cfg.d_model, dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(ks[1], cfg.vocab_size, cfg.d_model, dt).T
    init_layer = _init_mamba_block if cfg.family == "ssm" else _init_block
    # jax.vmap over the layer keys: one layer at a time into the stack
    blocks = None
    for i, k in enumerate(rng.split(ks[3], cfg.num_layers).unbind(0)):
        layer = init_layer(cfg, k)
        if blocks is None:
            blocks = _map(lambda t: t.new_empty((cfg.num_layers,) + t.shape),
                          layer)
        _map(lambda dst, src: dst[i].copy_(src), blocks, layer)
    p["blocks"] = blocks
    return p


def params_from_jax(cfg, tree, device=None):
    """The reference's ``init_params`` tree (numpy arrays, e.g. through
    ``jax.tree.map(np.asarray, ...)``) as the port's parameters on
    ``device`` (default: the GPU).  The layouts are the same."""
    _check(cfg)
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(np.array(a)).to(device)

    return _map(leaf, tree)


def unembed_matrix(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------

def _attn_block(cfg, p, x, q_pos, kv_pos, cache):
    x = constrain(x, "resid")
    h = apply_norm(cfg, p["ln1"], x)
    a, cache = gqa_attention(cfg, p["attn"], h, q_pos, kv_pos, cache)
    x = x + a
    h = apply_norm(cfg, p["ln2"], x)
    return x + mlp(cfg, p["mlp"], h), cache


def _mamba_block(cfg, p, x, cache):
    x = constrain(x, "resid")
    h = apply_norm(cfg, p["ln"], x)
    y, cache = mamba2_forward(cfg, p["mamba"], h, cache)
    return x + y, cache


def forward(cfg, params, batch, cache=None):
    """Returns (logits (B, T, V), aux_loss, new_cache).

    ``batch["tokens"]``: (B, T) int.  With ``cache``: decode (T == 1) or
    cache-building prefill (T > 1).  The cache's tensors are written in
    place; the returned cache holds them and the advanced ``pos``."""
    _check(cfg)
    if cache is None:
        raise NotImplementedError(
            "the no-cache (training) forward is not ported yet: ROADMAP A15")
    tokens = batch["tokens"]
    B, T = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens]

    pos0 = int(cache["pos"])
    layers = cache["layers"]
    blocks = params["blocks"]
    if cfg.family == "ssm":   # no positions: the state carries the past
        for i in range(cfg.num_layers):
            x, _ = _mamba_block(cfg, _map(lambda t: t[i], blocks), x,
                                {k: v[i] for k, v in layers.items()})
    else:
        Sc = layers["k"].shape[2]
        q_pos = (pos0 + torch.arange(T, device=dev)).expand(B, T)
        if T == 1:
            kv_pos = kvcache.kv_positions(cfg, pos0, Sc, B, dev)
        else:
            kv_pos = q_pos   # prefill: attention over the live keys
        for i in range(cfg.num_layers):
            x, _ = _attn_block(cfg, _map(lambda t: t[i], blocks), x, q_pos,
                               kv_pos, {k: v[i] for k, v in layers.items()})

    x = apply_norm(cfg, params["final_norm"], constrain(x, "resid"))
    logits = constrain(x @ unembed_matrix(cfg, params), "logits")
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return logits, aux, {"pos": pos0 + T, "layers": layers}
