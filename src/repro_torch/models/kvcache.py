"""Decode-time caches of every family.

Layout, as in the reference, every per-layer leaf stacked on a leading
layer axis (the hybrid's on its super-block axes):

  dense, vlm, moe : {"pos": int, "layers": {"k", "v": (L, B, Sc, Hkv, hd)}}
  mla             : {"pos": int, "layers": {"ckv": (L, B, Sc, kv_lora),
                                            "kr": (L, B, Sc, rope_head_dim)}}
  ssm             : {"pos": int, "layers": {"state": (L, B, H, N, P) float32,
                                            "conv": (L, B, k-1, Cd)}}
  hybrid          : {"pos": int, "mamba": {"state": (G, A, B, H, N, P)
                                           float32, "conv": (G, A, B, k-1, Cd)},
                                 "attn": {"k", "v": (G, B, Sc, Hkv, hd)}}
  audio           : the dense cache + {"xk", "xv": (L, B, Senc, Hkv, hd)},
                    the encoder's cross-attention K/V

with G = L // attn_every super-blocks of A = attn_every mamba layers;
the one shared attention block keeps a cache per super-block.  ``Sc`` is
``min(seq_len, sliding_window)``: a sliding-window cache is a ring
buffer.  ``pos`` (the next position to write) is a Python int here; key
positions are derived from it (:func:`kv_positions`), so empty and ring
slots need no stored metadata.

The MLA cache (deepseek-v2, a moe-family config with ``attn_type
"mla"``) holds the latent and the one rope key a position, for all
heads; it is linear (no window).  With ``kv_quant`` a GQA cache (the
hybrid's attention part too) holds int8 ``k``/``v`` and float32
``k_scale``/``v_scale`` of (..., B, Sc, Hkv): one scale a position and
head.
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
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "audio"):
        raise ValueError(f"no cache for family {cfg.family}")


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
    if cfg.kv_quant:
        sc = rows + (cfg.num_kv_heads,)
        return {"k": (kv, torch.int8), "v": (kv, torch.int8),
                "k_scale": (sc, torch.float32), "v_scale": (sc, torch.float32)}
    return {"k": (kv, dtype_of(cfg)), "v": (kv, dtype_of(cfg))}


def cache_shapes(cfg, batch: int, seq_len: int):
    """Full cache tree of (shape, dtype) pairs."""
    _check(cfg)
    L = cfg.num_layers
    out = {"pos": ((), torch.int32)}
    if cfg.family == "ssm":
        out["layers"] = _mamba_shapes(cfg, (L,), batch)
    elif cfg.family == "hybrid":
        G, A = L // cfg.attn_every, cfg.attn_every
        out["mamba"] = _mamba_shapes(cfg, (G, A), batch)
        out["attn"] = _kv_shapes(cfg, (G,), batch, seq_len)
    else:
        out["layers"] = _kv_shapes(cfg, (L,), batch, seq_len)
    if cfg.family == "audio":
        xkv = (L, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
        out["layers"]["xk"] = (xkv, dtype_of(cfg))
        out["layers"]["xv"] = (xkv, dtype_of(cfg))
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


def cache_specs(cfg, batch: int, seq_len: int):
    """The cache tree as tensors on the meta device (shapes and dtypes,
    nothing allocated), ``pos`` a 0-d int32 as in the reference."""
    return {group: (torch.empty(leaves[0], dtype=leaves[1], device="meta")
                    if group == "pos" else
                    {k: torch.empty(s, dtype=d, device="meta")
                     for k, (s, d) in leaves.items()})
            for group, leaves in cache_shapes(cfg, batch, seq_len).items()}


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
