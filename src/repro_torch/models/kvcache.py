"""Decode-time caches of the dense, MoE, SSM and hybrid families.

Layout, as in the reference, every per-layer leaf stacked on a leading
layer axis (the hybrid's on its super-block axes):

  dense, moe : {"pos": int, "layers": {"k", "v": (L, B, Sc, Hkv, hd)}}
  mla        : {"pos": int, "layers": {"ckv": (L, B, Sc, kv_lora),
                                       "kr": (L, B, Sc, rope_head_dim)}}
  ssm        : {"pos": int, "layers": {"state": (L, B, H, N, P) float32,
                                       "conv": (L, B, k-1, Cd)}}
  hybrid     : {"pos": int, "mamba": {"state": (G, A, B, H, N, P) float32,
                                      "conv": (G, A, B, k-1, Cd)},
                            "attn": {"k", "v": (G, B, Sc, Hkv, hd)}}

with G = L // attn_every super-blocks of A = attn_every mamba layers;
the one shared attention block keeps a cache per super-block.  ``Sc`` is
``min(seq_len, sliding_window)``: a sliding-window cache is a ring
buffer.  ``pos`` (the next position to write) is a Python int here; key
positions are derived from it (:func:`kv_positions`), so empty and ring
slots need no stored metadata.

The MLA cache (deepseek-v2, a moe-family config with ``attn_type
"mla"``) holds the latent and the one rope key a position, for all
heads; it is linear (no window).  The audio cache and the int8
``kv_quant`` cache wait for their families (ROADMAP A15).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .layers import dtype_of
from .mamba2 import conv_dim


def cache_len(cfg, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def _check(cfg):
    if cfg.family == "ssm":
        return
    if cfg.family not in ("dense", "moe", "hybrid") \
            or cfg.attn_type not in ("gqa", "mla"):
        raise NotImplementedError(
            f"cache of family {cfg.family!r} / attention {cfg.attn_type!r}"
            " is not ported yet: ROADMAP A15")
    if cfg.kv_quant:
        raise NotImplementedError(
            "the int8 KV cache (kv_quant) is not ported yet: ROADMAP A15")


def _mamba_shapes(cfg, lead, batch: int):
    return {"state": (lead + (batch, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim), torch.float32),
            "conv": (lead + (batch, cfg.ssm_conv - 1, conv_dim(cfg)),
                     dtype_of(cfg))}


def _kv_shapes(cfg, lead, batch: int, seq_len: int):
    rows = lead + (batch, cache_len(cfg, seq_len))
    if cfg.attn_type == "mla":
        return {"ckv": (rows + (cfg.kv_lora_rank,), dtype_of(cfg)),
                "kr": (rows + (cfg.rope_head_dim,), dtype_of(cfg))}
    kv = rows + (cfg.num_kv_heads, cfg.head_dim)
    return {"k": (kv, dtype_of(cfg)), "v": (kv, dtype_of(cfg))}


def cache_shapes(cfg, batch: int, seq_len: int):
    """Full cache tree of (shape, dtype) pairs."""
    _check(cfg)
    L = cfg.num_layers
    out = {"pos": ((), torch.int64)}
    if cfg.family == "ssm":
        out["layers"] = _mamba_shapes(cfg, (L,), batch)
    elif cfg.family == "hybrid":
        G, A = L // cfg.attn_every, cfg.attn_every
        out["mamba"] = _mamba_shapes(cfg, (G, A), batch)
        out["attn"] = _kv_shapes(cfg, (G,), batch, seq_len)
    else:
        out["layers"] = _kv_shapes(cfg, (L,), batch, seq_len)
    return out


def init_cache(cfg, batch: int, seq_len: int, device=None):
    """An empty cache on ``device`` (default: the GPU)."""
    device = resolve_device(device)
    shapes = cache_shapes(cfg, batch, seq_len)
    cache = {"pos": 0}
    for group, leaves in shapes.items():
        if group != "pos":
            cache[group] = {k: torch.zeros(s, dtype=d, device=device)
                            for k, (s, d) in leaves.items()}
    return cache


def kv_positions(cfg, pos: int, Sc: int, batch: int, device=None):
    """Positions held by each cache slot given the write pointer ``pos``
    (the position about to be written; slots with no data -> -1):
    (batch, Sc) int32."""
    slots = torch.arange(Sc, device=device)
    # ring buffer iff the cache was capped at the sliding window
    if cfg.sliding_window is not None and Sc == cfg.sliding_window:
        q = pos - ((pos - slots) % Sc)   # largest q <= pos, q % Sc == slot
        kv = torch.where(q >= 0, q, -1)
    else:
        kv = torch.where(slots <= pos, slots, -1)
    return kv.expand(batch, Sc).to(torch.int32)
