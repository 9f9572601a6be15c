"""Rotary position embeddings (rotate-half convention).  Qwen2-VL's
M-RoPE waits for the vlm family (ROADMAP A15)."""
from __future__ import annotations

import torch


def _inv_freq(half_dim: int, theta: float, device=None):
    ar = torch.arange(0, half_dim, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / half_dim))


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (B, S) int -> cos/sin (B, S, head_dim//2) float32."""
    inv = _inv_freq(head_dim // 2, theta, positions.device)
    ang = positions[..., None].to(torch.float32) * inv   # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions3, head_dim: int, theta: float):
    raise NotImplementedError(
        "M-RoPE (qwen2-vl) is not ported yet: ROADMAP A15")


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D//2).  The rotation runs in
    x.dtype, as in the reference."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)   # broadcast over heads
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
