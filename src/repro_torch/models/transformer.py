"""Architecture assembly of the dense, MoE, SSM and hybrid families: init,
the no-cache (training) forward, cache-building prefill and single-token
decode, plus the :class:`Transformer` facade and the federated
:class:`TransformerClassifier`.

Parameters are a nested dict of tensors with the reference's tree and
layouts: every block leaf is stacked on a leading layer axis ``(L, ...)``
and dense weights are ``(in, out)`` applied as ``x @ W``.  The layers run
as a Python loop over that axis (the reference's ``lax.scan``); in the
no-cache forward each layer (each super-block in the hybrid) is
recomputed in the backward when autograd records it
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` with
``nothing_saveable`` does.

The hybrid family (zamba2) stacks its mamba blocks on two axes
``(G, A, ...)``: G = L // attn_every super-blocks of A = attn_every
mamba layers, each followed by the one ``shared_attn`` block (the same
weights every super-block, a cache of its own in each).

The MoE family (qwen2-moe, deepseek-v2) is the dense block with ``moe``
in place of ``mlp`` (:mod:`repro_torch.models.moe`); each layer's router
loss adds into the float32 ``aux`` that :func:`forward` returns.  A
block whose config has ``attn_type "mla"`` (deepseek-v2) attends through
:func:`~repro_torch.models.attention.mla_attention` and keeps the latent
cache.

The vlm family (qwen2-vl) is the dense block fed embeddings, its q and k
rotated by M-RoPE over three position streams (text-only: three copies
of the token positions).  The audio family (whisper) adds cross-
attention to each block (``ln_x`` and the ``xw*`` weights): its K/V come
from ``batch["enc_out"]`` when given (the prefill, and every decode step
of the serve, as in the reference) and from the cache's ``xk``/``xv``
otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import rng
from ..device import resolve_device
from . import kvcache
from .attention import (check_supported, cross_attention, encode_cross_kv,
                        gqa_attention, init_attn, mla_attention)
from .layers import (apply_norm, dense_init, dtype_of, embed_init, init_norm,
                     checkpointed)
from .mamba2 import init_mamba, mamba2_forward
from .mlp import init_mlp, mlp
from .moe import init_moe, moe_ffn
from .shardhooks import constrain


_FAMILIES = ("dense", "vlm", "moe", "audio", "ssm", "hybrid")
_ATTN_FAMILIES = ("dense", "vlm", "moe", "audio")   # one attention block a layer


def _check(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"family {cfg.family!r}: the reference takes one "
                         f"of {_FAMILIES}")
    if cfg.family != "ssm":
        check_supported(cfg)
    elif cfg.pos_emb not in ("rope", "learned"):
        raise ValueError(f"pos_emb={cfg.pos_emb!r}: the reference takes "
                         "rope or learned")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(cfg, key):
    ks = rng.split(key, 4).unbind(0)
    dev = key.device
    p = {"ln1": init_norm(cfg, cfg.d_model, dev),
         "ln2": init_norm(cfg, cfg.d_model, dev),
         "attn": init_attn(cfg, ks[0])}
    if cfg.is_moe:
        p["moe"] = init_moe(cfg, ks[1])
    else:
        p["mlp"] = init_mlp(cfg, ks[1])
    if cfg.cross_attention:
        p["ln_x"] = init_norm(cfg, cfg.d_model, dev)
    return p


def _init_mamba_block(cfg, key):
    return {"ln": init_norm(cfg, cfg.d_model, key.device),
            "mamba": init_mamba(cfg, key)}


def tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_params(cfg, key, device=None):
    """The reference's ``init_params(cfg, key)`` on ``device`` (default:
    the GPU).  Same key, same weights (normals within 4 float32 ulps)."""
    _check(cfg)
    key = key.to(resolve_device(device))
    ks = rng.split(key, 8).unbind(0)
    dt = dtype_of(cfg)
    p = {"final_norm": init_norm(cfg, cfg.d_model, key.device)}
    if not cfg.embed_input:
        p["embed"] = embed_init(ks[0], cfg.vocab_size, cfg.d_model, dt)
    if not cfg.tie_embeddings or cfg.embed_input:
        p["unembed"] = embed_init(ks[1], cfg.vocab_size, cfg.d_model, dt).T
    if cfg.pos_emb == "learned":
        p["pos_embed"] = embed_init(ks[2], cfg.max_position, cfg.d_model, dt)
    hybrid = cfg.family == "hybrid"
    init_layer = (_init_block if cfg.family in _ATTN_FAMILIES
                  else _init_mamba_block)
    n = cfg.num_layers
    if hybrid:   # G * A mamba layers from one split, then (G, A, ...)
        G, A = cfg.num_layers // cfg.attn_every, cfg.attn_every
        n = G * A
    # jax.vmap over the layer keys: one layer at a time into the stack
    blocks = None
    for i, k in enumerate(rng.split(ks[3], n).unbind(0)):
        layer = init_layer(cfg, k)
        if blocks is None:
            blocks = tree_map(lambda t: t.new_empty((n,) + t.shape), layer)
        tree_map(lambda dst, src: dst[i].copy_(src), blocks, layer)
        del layer   # the next draw does not hold this layer beside it
    if hybrid:
        blocks = tree_map(lambda t: t.view((G, A) + t.shape[1:]), blocks)
        p["shared_attn"] = _init_block(cfg, ks[4])   # one shared block
    p["blocks"] = blocks
    return p


def _from_numpy(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(cfg, tree, device=None):
    """A reference parameter tree (numpy arrays, e.g. through
    ``jax.tree.map(np.asarray, ...)``) as the port's parameters on
    ``device`` (default: the GPU).  The layouts are the same, so this
    takes ``init_params``'s tree, a tree stacked on leading axes (the
    federated LM steps' pods) and, with ``cfg`` None, any tree."""
    if cfg is not None:
        _check(cfg)
    device = resolve_device(device)
    return tree_map(lambda a: _from_numpy(a, device), tree)


def unembed_matrix(cfg, params):
    if cfg.tie_embeddings and not cfg.embed_input:
        return params["embed"].T
    return params["unembed"]


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------

def _attn_block(cfg, p, x, q_pos, kv_pos, cache, positions3=None,
                enc_out=None):
    """Returns (x, the layer's router loss or None, cache).  With
    ``cfg.cross_attention`` the cross K/V come from ``enc_out`` when it
    is given (and are written into the cache's ``xk``/``xv``), else from
    the cache (decode only)."""
    x = constrain(x, "resid")
    h = apply_norm(cfg, p["ln1"], x)
    if cfg.attn_type == "mla":
        a, cache = mla_attention(cfg, p["attn"], h, q_pos, kv_pos, cache)
    else:
        a, cache = gqa_attention(cfg, p["attn"], h, q_pos, kv_pos, cache,
                                 positions3)
    x = x + a
    if cfg.cross_attention:
        h = apply_norm(cfg, p["ln_x"], x)
        if enc_out is not None:
            ekv = encode_cross_kv(cfg, p["attn"], enc_out)
            if cache is not None:
                cache["xk"].copy_(ekv["k"])
                cache["xv"].copy_(ekv["v"])
        elif cache is not None and x.shape[1] == 1:
            ekv = {"k": cache["xk"], "v": cache["xv"]}
        else:
            raise ValueError("cross-attention needs batch['enc_out'] "
                             "(only a decode step reads the cached xk/xv)")
        x = x + cross_attention(cfg, p["attn"], h, ekv)
    h = apply_norm(cfg, p["ln2"], x)
    if cfg.is_moe:
        y, aux = moe_ffn(cfg, p["moe"], h)
        return x + y, aux, cache
    return x + mlp(cfg, p["mlp"], h), None, cache


def _mamba_block(cfg, p, x, cache):
    x = constrain(x, "resid")
    h = apply_norm(cfg, p["ln"], x)
    y, cache = mamba2_forward(cfg, p["mamba"], h, cache)
    return x + y, cache


def _at(tree, *idx):
    return tree_map(lambda t: t[idx], tree)


def _layers(tree):
    """The per-layer trees of a tree stacked on a leading layer axis:
    one ``unbind`` a leaf, whose backward stacks the layers' gradients
    once (indexing a layer would build a zero stack a layer and add)."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    n = len(tree_leaves(parts)[0])
    return [tree_map(lambda u: u[i], parts) for i in range(n)]


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def forward(cfg, params, batch, cache=None, *, remat=True,
            return_hidden=False):
    """Returns (logits (B, T, V), aux_loss, new_cache), or the
    final-normed hidden (B, T, D) in place of the logits with
    ``return_hidden`` (the chunked loss unembeds it itself).

    ``batch["tokens"]``: (B, T) int, or ``batch["embeds"]``: (B, T, D);
    ``batch["enc_out"]``: (B, Senc, D), the encoder's output, for a
    cross-attention config (optional in decode, which then reads the
    cached cross K/V).
    Without ``cache``: the training forward over positions 0..T-1 (each
    layer recomputed in the backward with ``remat``; new_cache None).
    With ``cache``: decode (T == 1) or cache-building prefill (T > 1);
    the cache's tensors are written in place, and the returned cache
    holds them and the advanced ``pos``."""
    _check(cfg)
    if "embeds" in batch:
        x = batch["embeds"].to(dtype_of(cfg))
    else:
        x = params["embed"][batch["tokens"]]
    B, T = x.shape[:2]
    dev = x.device
    pos0 = 0 if cache is None else int(cache["pos"])
    q_pos = (pos0 + torch.arange(T, device=dev)).expand(B, T)
    kv_pos = q_pos   # train / prefill: attention over the live keys
    if cfg.family != "ssm" and cache is not None and T == 1:
        Sc = (cache["attn"] if cfg.family == "hybrid"
              else cache["layers"])[
            "ckv" if cfg.attn_type == "mla" else "k"].shape[2]
        kv_pos = kvcache.kv_positions(cfg, pos0, Sc, B, dev)
    # text-only M-RoPE: the (t, h, w) streams are the token positions
    positions3 = torch.stack([q_pos] * 3, -1) if cfg.mrope else None
    enc_out = batch.get("enc_out")
    if cfg.pos_emb == "learned":
        x = x + params["pos_embed"][q_pos[0]][None]
    # each layer keeps only its input for the backward
    recompute = remat and cache is None and torch.is_grad_enabled()
    blocks = params["blocks"]
    aux = torch.zeros((), dtype=torch.float32, device=dev)

    def attn(x, p, c=None):
        return _attn_block(cfg, p, x, q_pos, kv_pos, c, positions3,
                           enc_out)[:2]

    def mamba(x, p, c=None):
        return _mamba_block(cfg, p, x, c)[0]

    if cfg.family == "ssm":   # no positions: the state carries the past
        for i, p in enumerate(_layers(blocks)):
            c = None if cache is None else _at(cache["layers"], i)
            x = checkpointed(recompute, mamba, x, p, c)
    elif cfg.family == "hybrid":   # the reference's _scan_hybrid

        def super_block(x, g, group, cache):
            for a, p in enumerate(_layers(group)):
                c = None if cache is None else _at(cache["mamba"], g, a)
                x = mamba(x, p, c)
            c = None if cache is None else _at(cache["attn"], g)
            return attn(x, params["shared_attn"], c)[0]

        for g, group in enumerate(_layers(blocks)):
            x = checkpointed(recompute, super_block, x, g, group, cache)
    else:   # the reference's scan carries (x, aux) over the layers
        for i, p in enumerate(_layers(blocks)):
            c = None if cache is None else _at(cache["layers"], i)
            x, a = checkpointed(recompute, attn, x, p, c)
            if a is not None:
                aux = aux + a

    x = apply_norm(cfg, params["final_norm"], constrain(x, "resid"))
    new_cache = None if cache is None else dict(cache, pos=pos0 + T)
    if return_hidden:
        return x, aux, new_cache
    logits = constrain(x @ unembed_matrix(cfg, params), "logits")
    return logits, aux, new_cache


# ---------------------------------------------------------------------------
# Facade + param accounting
# ---------------------------------------------------------------------------

class Transformer:
    """Thin facade bundling config + functions (the reference's)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, key, device=None):
        return init_params(self.cfg, key, device=device)

    def apply(self, params, batch, cache=None, remat=True):
        return forward(self.cfg, params, batch, cache, remat=remat)

    def init_cache(self, batch_size, seq_len, device=None):
        return kvcache.init_cache(self.cfg, batch_size, seq_len,
                                  device=device)


def active_params(cfg, params) -> int:
    """Active parameters per token (MoE: top_k of routed experts)."""
    total = count_params(params)
    if not cfg.is_moe:
        return total
    routed = sum(params["blocks"]["moe"][w].numel()
                 for w in ("w1", "w2", "w3"))
    return int(total - routed + routed * cfg.top_k / cfg.num_experts)


# ---------------------------------------------------------------------------
# The federated transformer classifier
# ---------------------------------------------------------------------------

_SEP = "/"


def flatten_tree(tree, prefix=""):
    """A nested dict of tensors as one level, keys joined by "/".  Sorted
    keys of the flat dict follow ``jax.tree.flatten``'s order ("/" sorts
    before every character of a key)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, prefix + k + _SEP))
        else:
            out[prefix + k] = v
    return out


def nest_tree(flat):
    """Inverse of :func:`flatten_tree`."""
    out = {}
    for path, v in flat.items():
        *parents, leaf = path.split(_SEP)
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


class TransformerClassifier:
    """Tiny dense transformer as a federated client model: flatten the
    input, cut it into ``seq_len`` patch tokens, project to d_model, run
    the dense stack (``embed_input`` front door, learned positions, GELU
    MLP), mean-pool the position logits.  The reference's classifier.

    Same contract as the CNN and the MLP (``init``, ``apply``,
    ``apply_stacked``, ``num_params``; float32 params, logits (B,
    num_classes)).  Parameters are two levels deep, as the round loop's
    tree operations take them: ``{"patch": {"w", "b"}, "tf": {path:
    leaf}}``, where ``tf`` is the reference's ``init_params`` tree with
    its keys joined by "/" (:func:`flatten_tree`)."""

    def __init__(self, num_classes: int, input_shape: tuple,
                 d_model: int = 32, num_layers: int = 2, num_heads: int = 2,
                 head_dim: int = 16, d_ff: int = 64, seq_len: int = 16):
        from ..configs import ArchConfig
        self.num_classes = num_classes
        self.input_shape = tuple(int(s) for s in input_shape)
        total = int(np.prod(self.input_shape))
        if total % seq_len:
            raise ValueError(
                f"input shape {self.input_shape} ({total} features) does "
                f"not split into seq_len={seq_len} patch tokens")
        self.seq_len = seq_len
        self.patch_dim = total // seq_len
        self.cfg = ArchConfig(
            name="fed_transformer", family="dense",
            source="registry classifier (this repo)",
            num_layers=num_layers, d_model=d_model, num_heads=num_heads,
            num_kv_heads=num_heads, d_ff=d_ff, vocab_size=num_classes,
            head_dim=head_dim, attn_type="gqa", pos_emb="learned",
            max_position=seq_len, embed_input=True, mlp_act="gelu",
            param_dtype="float32")

    def init(self, key):
        """Parameters from ``key`` (the reference's draws, on the key's
        device)."""
        kp, kt = rng.split(key, 2).unbind(0)
        patch = {"w": dense_init(kp, self.patch_dim, self.cfg.d_model,
                                 torch.float32),
                 "b": torch.zeros((self.cfg.d_model,), device=key.device)}
        return {"patch": patch,
                "tf": flatten_tree(init_params(self.cfg, kt,
                                               device=key.device))}

    def apply(self, params, x):
        """x: (B, *input_shape) -> logits (B, num_classes)."""
        if tuple(x.shape[1:]) != self.input_shape:
            raise ValueError(
                f"TransformerClassifier built for input shape "
                f"{self.input_shape} but got a batch of shape "
                f"{tuple(x.shape[1:])}")
        toks = x.reshape(x.shape[0], self.seq_len, self.patch_dim)
        h = toks @ params["patch"]["w"] + params["patch"]["b"]
        logits, _, _ = forward(self.cfg, nest_tree(params["tf"]),
                               {"embeds": h}, remat=False)
        return logits.mean(1)

    def apply_stacked(self, params, x):
        """Device-stacked forward: params leaves (D, ...), x (D, B,
        *input_shape) -> logits (D, B, num_classes), one device at a
        time (the reference's vmap)."""
        return torch.stack([
            self.apply({k: {n: t[d] for n, t in v.items()}
                        for k, v in params.items()}, x[d])
            for d in range(x.shape[0])])

    @staticmethod
    def num_params(params) -> int:
        return sum(t.numel() for v in params.values() for t in v.values())


def classifier_from_jax(params_np, device="cpu"):
    """The reference classifier's parameters (numpy arrays, leading
    device axes allowed) -> the port's two-level tree."""
    return {"patch": params_from_jax(None, params_np["patch"], device),
            "tf": flatten_tree(params_from_jax(None, params_np["tf"],
                                               device))}
