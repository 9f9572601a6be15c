"""Rotary position embeddings (rotate-half convention): standard RoPE and
Qwen2-VL's M-RoPE."""
from __future__ import annotations

import torch

# M-RoPE: the half-dim is split into (temporal, height, width) sections.
# Fractions follow Qwen2-VL (16/24/24 of a 64 half-dim).
MROPE_FRACS = (0.25, 0.375, 0.375)


def _inv_freq(half_dim: int, theta: float, device=None):
    ar = torch.arange(0, half_dim, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / half_dim))


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (B, S) int -> cos/sin (B, S, head_dim//2) float32."""
    inv = _inv_freq(head_dim // 2, theta, positions.device)
    ang = positions[..., None].to(torch.float32) * inv   # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions3, head_dim: int, theta: float):
    """positions3: (B, S, 3) int (t, h, w) -> cos/sin (B, S, head_dim//2)
    float32.  Each stream drives its own slice of the inverse
    frequencies; identical streams give :func:`rope_cos_sin`'s angles
    bit for bit (the same float32 products)."""
    half = head_dim // 2
    inv = _inv_freq(half, theta, positions3.device)
    sizes = [int(round(f * half)) for f in MROPE_FRACS]
    sizes[-1] = half - sizes[0] - sizes[1]
    parts, start = [], 0
    for sec, size in enumerate(sizes):
        p = positions3[..., sec].to(torch.float32)   # (B, S)
        parts.append(p[..., None] * inv[start:start + size])
        start += size
    ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D//2).  The rotation runs in
    x.dtype, as in the reference."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)   # broadcast over heads
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
