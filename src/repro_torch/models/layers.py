"""Shared primitive layers: norms, linear init, embeddings, activations.

Initializers draw through :mod:`repro_torch.rng`, so a key gives the
reference's weights (``jax.random.normal``, within 4 float32 ulps).
Large arrays are drawn in row chunks with the stream unchanged, which
keeps the int64 threefry temporaries of the (151936, 896) embedding of
qwen2-0.5b to a few hundred MB.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import rng

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_CHUNK = 1 << 24   # elements per normal draw


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def scaled_normal(key, shape, scale: float, dtype) -> torch.Tensor:
    """``(jax.random.normal(key, shape, f32) * scale).astype(dtype)`` for
    one key, drawn in chunks of whole rows on the key's device."""
    shape = tuple(shape)
    out = torch.empty(shape, dtype=dtype, device=key.device)
    rows, cols = shape[0], math.prod(shape[1:])
    step = max(1, _CHUNK // max(cols, 1))
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        out[r0:r1] = (rng.normal(key, (r1 - r0,) + shape[1:],
                                 offset=r0 * cols) * scale).to(dtype)
    return out


def dense_init(key, in_dim: int, out_dim: int, dtype, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return scaled_normal(key, (in_dim, out_dim), scale, dtype)


def embed_init(key, vocab: int, dim: int, dtype):
    return scaled_normal(key, (vocab, dim), 0.02, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg, dim: int, device=None):
    p = {"scale": torch.ones((dim,), dtype=dtype_of(cfg), device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype_of(cfg), device=device)
    return p


def _sumsq(a, b):
    """Σ a·b over the last axis, accumulated in float32, keepdim."""
    return (a.float() * b.float()).sum(-1, keepdim=True)


def apply_norm(cfg, p, x):
    """RMSNorm / LayerNorm with float32 accumulation.  As in the
    reference, the inverse scale is cast to ``x.dtype`` before the
    multiply, and ``x * inv * scale`` rounds after each product."""
    d = x.shape[-1]
    if cfg.norm_type == "layernorm":
        mu = x.float().mean(-1, keepdim=True)
        xc = x - mu.to(x.dtype)
        var = _sumsq(xc, xc) / d
        inv = torch.rsqrt(var + cfg.norm_eps).to(x.dtype)
        return xc * inv * p["scale"] + p["bias"]
    ms = _sumsq(x, x) / d
    inv = torch.rsqrt(ms + cfg.norm_eps).to(x.dtype)
    return x * inv * p["scale"]


def rms_norm_headwise(x, scale, eps: float = 1e-6):
    """qk-norm: rmsnorm over the head_dim axis of (..., head_dim)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def grad_dtype_guard(x):
    """The identity: the serve path takes no gradients (the reference's
    cotangent cast matters only in its backward)."""
    return x
