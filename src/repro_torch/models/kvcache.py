"""Decode-time caches of the dense and SSM families.

Layout, as in the reference, every per-layer leaf stacked on a leading
layer axis:

  dense : {"pos": int, "layers": {"k", "v": (L, B, Sc, Hkv, hd)}}
  ssm   : {"pos": int, "layers": {"state": (L, B, H, N, P) float32,
                                  "conv": (L, B, k-1, Cd)}}

``Sc`` is ``min(seq_len, sliding_window)``: a sliding-window cache is a
ring buffer.  ``pos`` (the next position to write) is a Python int here;
key positions are derived from it (:func:`kv_positions`), so empty and
ring slots need no stored metadata.

The MLA, hybrid and audio caches and the int8 ``kv_quant`` cache wait
for their families (ROADMAP A15).
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
    if cfg.family != "dense" or cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"cache of family {cfg.family!r} / attention {cfg.attn_type!r}"
            " is not ported yet: ROADMAP A15")
    if cfg.kv_quant:
        raise NotImplementedError(
            "the int8 KV cache (kv_quant) is not ported yet: ROADMAP A15")


def cache_shapes(cfg, batch: int, seq_len: int):
    """Full cache tree of (shape, dtype) pairs."""
    _check(cfg)
    dt = dtype_of(cfg)
    L = cfg.num_layers
    if cfg.family == "ssm":
        return {"pos": ((), torch.int64), "layers": {
            "state": ((L, batch, cfg.ssm_heads, cfg.ssm_state,
                       cfg.ssm_head_dim), torch.float32),
            "conv": ((L, batch, cfg.ssm_conv - 1, conv_dim(cfg)), dt)}}
    kv = (L, batch, cache_len(cfg, seq_len), cfg.num_kv_heads,
          cfg.head_dim)
    return {"pos": ((), torch.int64),
            "layers": {"k": (kv, dt), "v": (kv, dt)}}


def init_cache(cfg, batch: int, seq_len: int, device=None):
    """An empty cache on ``device`` (default: the GPU)."""
    device = resolve_device(device)
    shapes = cache_shapes(cfg, batch, seq_len)
    return {"pos": 0,
            "layers": {k: torch.zeros(s, dtype=d, device=device)
                       for k, (s, d) in shapes["layers"].items()}}


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
