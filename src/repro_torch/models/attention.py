"""Grouped-query attention (GQA; optional sliding window and QKV bias).

All masking is position-driven, as in the reference: query positions
``q_pos`` (B, T) and key positions ``kv_pos`` (B, S), with -1 marking
empty cache slots.

Prefill (``T > 1`` writing a fresh cache) is causal self-attention over
the prompt's own positions, so it goes through the flash-attention
kernel (:func:`repro_torch.kernels.flash_attention.flash_attention`,
``csrc/flash_attention.cu`` on the GPU).  Decode (``T == 1``) attends
to the cache through :func:`masked_attention`, plain PyTorch, as the
reference's decode is plain jnp.

MLA, cross-attention, qk-norm, M-RoPE and the int8 cache wait for the
families that use them (ROADMAP A15).
"""
from __future__ import annotations

import math

import torch

from .. import rng
from ..kernels.flash_attention import flash_attention
from .layers import dense_init, dtype_of
from .rope import apply_rope, rope_cos_sin
from .shardhooks import constrain

NEG_INF = -1e30


def check_supported(cfg) -> None:
    """Raise for every attention option this slice does not run."""
    todo = {"attn_type": cfg.attn_type != "gqa",
            "qk_norm": cfg.qk_norm, "mrope": cfg.mrope,
            "cross_attention": cfg.cross_attention,
            "kv_quant": cfg.kv_quant,
            "pos_emb": cfg.pos_emb != "rope"}
    for name, hit in todo.items():
        if hit:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r} is not ported yet: "
                "ROADMAP A15")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_attn(cfg, key):
    check_supported(cfg)
    dt = dtype_of(cfg)
    D, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ks = rng.split(key, 10).unbind(0)
    p = {"wq": dense_init(ks[0], D, H * hd, dt),
         "wk": dense_init(ks[1], D, Hkv * hd, dt),
         "wv": dense_init(ks[2], D, Hkv * hd, dt),
         "wo": dense_init(ks[3], H * hd, D, dt)}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", Hkv * hd), ("bv", Hkv * hd)):
            p[name] = torch.zeros((n,), dtype=dt, device=key.device)
    return p


# ---------------------------------------------------------------------------
# Core masked attention (grouped-query, never repeats KV)
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, kv_pos, window, causal):
    """(B, T, S) additive float32 bias from positions."""
    valid = kv_pos[:, None, :] >= 0
    if causal:
        valid = valid & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        valid = valid & ((q_pos[:, :, None] - kv_pos[:, None, :]) < window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(valid, zero, NEG_INF)


def masked_attention(q, k, v, q_pos, kv_pos, *, scale, window=None,
                     causal=True):
    """Grouped attention, the reference's dense path.  q: (B,T,Hq,d),
    k/v: (B,S,Hkv,dv).  Scores in float32; the probabilities are cast to
    v's dtype before the product with V."""
    B, T, Hq, d = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, d)
    bias = _mask_bias(q_pos, kv_pos, window, causal)            # (B,T,S)
    s = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float())
    s = s * scale + bias[:, None, None]
    s = constrain(s, "scores_seq")
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype), v)
    return o.reshape(B, T, Hq, v.shape[-1])


def prefill_attention(q, k, v, window=None):
    """Causal self-attention over the prompt through the flash kernel.
    q: (B,T,H,d), k/v: (B,T,Hkv,dv) -> (B,T,H,dv).

    Query head h reads KV head h // G (the reference's
    ``q.reshape(B, T, Hkv, G, d)``), hence ``repeat_interleave``; heads
    are flattened into the batch as the kernel's (BH, S, d) contract
    asks."""
    B, T, H, d = q.shape
    G = H // k.shape[2]

    def flat(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, T, t.shape[-1])

    o = flash_attention(flat(q), flat(k.repeat_interleave(G, dim=2)),
                        flat(v.repeat_interleave(G, dim=2)), window=window)
    return o.reshape(B, H, T, -1).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# GQA block forward
# ---------------------------------------------------------------------------

def _proj(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b
    return y


def gqa_attention(cfg, p, x, q_pos, kv_pos, cache=None):
    """x: (B,T,D); cache: a layer's ``{"k","v": (B,Sc,Hkv,hd)}`` or None.

    Returns (out, cache).  With a cache, T == 1 decodes (this token's
    k/v go into its slot) and T > 1 prefills (the cache is rebuilt from
    the prompt's tail).  Unlike the reference, which returns a new
    cache, the port writes the given cache tensors in place and returns
    them.  Without a cache the forward is the training path, which is
    not ported yet."""
    check_supported(cfg)
    if cache is None:
        raise NotImplementedError(
            "the no-cache (training) forward is not ported yet: ROADMAP A15")
    B, T, D = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = constrain(_proj(x, p["wq"], p.get("bq")).reshape(B, T, H, hd),
                  "heads")
    k = constrain(_proj(x, p["wk"], p.get("bk")).reshape(B, T, Hkv, hd),
                  "kv")
    v = constrain(_proj(x, p["wv"], p.get("bv")).reshape(B, T, Hkv, hd),
                  "kv")
    cos, sin = rope_cos_sin(q_pos, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if T == 1:
        # ---- decode: scatter this token's k/v into its slot ----
        slots = _cache_slots(cfg, q_pos, cache["k"].shape[1])   # (B,1)
        ck = _scatter_cache(cache["k"], k, slots)
        cv = _scatter_cache(cache["v"], v, slots)
        o = masked_attention(q, ck, cv, q_pos, kv_pos,
                             scale=1.0 / math.sqrt(hd),
                             window=cfg.sliding_window, causal=True)
    else:
        # ---- prefill: causal attention over the prompt, then the cache
        # from its tail ----
        o = prefill_attention(q, k, v, window=cfg.sliding_window)
        Sc = cache["k"].shape[1]
        cache["k"].copy_(_tail_cache(k, Sc))
        cache["v"].copy_(_tail_cache(v, Sc))
    return o.reshape(B, T, H * hd) @ p["wo"], cache


def _cache_slots(cfg, q_pos, cache_len):
    if cfg.sliding_window is not None and cache_len <= cfg.sliding_window:
        return q_pos % cache_len  # ring buffer
    return q_pos


def _scatter_cache(cache, new, slots):
    """cache: (B,Smax,H,d); new: (B,T,H,d); slots: (B,T) int.  Writes in
    place and returns ``cache`` (the reference returns a new array)."""
    B, T = slots.shape
    b_idx = torch.arange(B, device=slots.device)[:, None].expand(B, T)
    cache[b_idx, slots.long()] = new.to(cache.dtype)
    return cache


def _tail_cache(k, Sc: int):
    """A (ring) cache holding the last ``Sc`` of ``k``: (B,S,H,d)."""
    S = k.shape[1]
    if Sc == S:
        return k
    if Sc > S:  # linear cache with free slots at the end
        pad = k.new_zeros((k.shape[0], Sc - S) + k.shape[2:])
        return torch.cat([k, pad], dim=1)
    tail = k[:, S - Sc:]
    # position p lives at slot p % Sc; tail index i is position S-Sc+i
    return torch.roll(tail, shifts=(S - Sc) % Sc, dims=1)
