"""Grouped-query attention (GQA; optional sliding window, QKV bias and
qk-norm) and DeepSeek-V2's multi-head latent attention (MLA).

All masking is position-driven, as in the reference: query positions
``q_pos`` (B, T) and key positions ``kv_pos`` (B, S), with -1 marking
empty cache slots.

Causal self-attention over a sequence's own positions (the
cache-building prefill, and the no-cache forward) goes through the
flash-attention kernel (:func:`repro_torch.kernels.flash_attention.
flash_attention_heads`, ``csrc/flash_attention.cu`` on the GPU) when
autograd records nothing: the kernel has no backward.  It takes q, k
and v as the projections and rope leave them, K/V at their own kv
heads, and returns (B, T, H, dv): nothing is repeated, permuted or
concatenated around the call.  When a gradient is being
recorded (training) it takes :func:`masked_attention`, the reference's
differentiable math: dense for T <= ``CHUNKED_THRESHOLD``, above it the
chunked online softmax with each block recomputed in the backward, as
the reference's ``jax.checkpoint`` does.  Decode (``T == 1``) attends to
the cache through :func:`masked_attention`, as the reference's decode
is plain jnp.  Positions are learned (added to the embeddings by the
caller) or RoPE.

qk-norm (qwen3) RMS-normalises each head of q and k over its head dim
after the projections and before RoPE, as the reference does.

MLA (:func:`mla_attention`) keeps a latent cache: the normed 512-wide
``ckv`` and the one 64-wide rope key ``kr`` a position, shared by all
heads.  The prompt (and the no-cache forward) builds per-head keys
``[ckv @ wk_b, rope(kr)]`` and values ``ckv @ wv_b`` and takes the same
causal path as GQA (flash attention at (d, dv) = (nope + rope, v_head):
(192, 128) at the published widths): without a gradient, q is the
``wq_b`` projection's own buffer with its rope columns rotated in place,
and the kernel reads ``ckv @ wk_b`` and the one rope key (its
``k_shared``) as they are; with one, the reference's concatenations.
Decode attends in the latent space (the absorbed path): ``wk_b`` folded
into the query, ``wv_b`` applied after the softmax.

M-RoPE (qwen2-vl, ``cfg.mrope``) rotates q and k by the (t, h, w)
position streams ``positions3`` (:func:`~repro_torch.models.rope.
mrope_cos_sin`); MLA ignores them, as the reference does.

The int8 cache (``cfg.kv_quant``) holds int8 k/v and a float32 scale a
(position, head), symmetric over the head dim (:func:`_quantize_kv`,
rounding half to even as ``jnp.round`` does).  The prefill attends
through the kernel on the unquantized k/v and then writes the quantized
tail; decode writes this token's int8 k/v and scales into their slots
and attends to the whole cache dequantized to the compute dtype.

Cross-attention (whisper, :func:`cross_attention`) attends to the
encoder's K/V (:func:`encode_cross_kv`) through :func:`masked_attention`
with ``causal=False``: the flash kernel computes causal attention only,
so it stays on the reference's plain math.
"""
from __future__ import annotations

import math

import torch

from .. import rng
from ..kernels.flash_attention import flash_attention_heads
from ..kernels.runtime import is_sharded, records_grad
from .layers import checkpointed, dense_init, dtype_of, rms_norm_headwise
from .rope import apply_rope, mrope_cos_sin, rope_cos_sin
from .shardhooks import constrain, write_slots

NEG_INF = -1e30
# Above this many query tokens, masked_attention takes the chunked
# online-softmax path, so the (T, S) score matrix never exists in full.
CHUNKED_THRESHOLD = 1024
Q_CHUNK = 512
KV_CHUNK = 1024


def check_supported(cfg) -> None:
    """Raise for an attention type or position embedding the reference
    does not have."""
    for name, known in (("attn_type", ("gqa", "mla")),
                        ("pos_emb", ("rope", "learned"))):
        if getattr(cfg, name) not in known:
            raise ValueError(f"{name}={getattr(cfg, name)!r}: the "
                             f"reference takes one of {known}")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_attn(cfg, key):
    check_supported(cfg)
    dt = dtype_of(cfg)
    D, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ks = rng.split(key, 10).unbind(0)
    if cfg.attn_type == "mla":
        nope, rp, lora = hd, cfg.rope_head_dim, cfg.kv_lora_rank
        ones = dict(dtype=dt, device=key.device)
        return {"wq_a": dense_init(ks[0], D, cfg.q_lora_rank, dt),
                "q_norm": torch.ones((cfg.q_lora_rank,), **ones),
                "wq_b": dense_init(ks[1], cfg.q_lora_rank, H * (nope + rp),
                                   dt),
                "wkv_a": dense_init(ks[2], D, lora + rp, dt),
                "kv_norm": torch.ones((lora,), **ones),
                "wk_b": dense_init(ks[3], lora, H * nope, dt),
                "wv_b": dense_init(ks[4], lora, H * cfg.v_head, dt),
                "wo": dense_init(ks[5], H * cfg.v_head, D, dt)}
    p = {"wq": dense_init(ks[0], D, H * hd, dt),
         "wk": dense_init(ks[1], D, Hkv * hd, dt),
         "wv": dense_init(ks[2], D, Hkv * hd, dt),
         "wo": dense_init(ks[3], H * hd, D, dt)}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", Hkv * hd), ("bv", Hkv * hd)):
            p[name] = torch.zeros((n,), dtype=dt, device=key.device)
    if cfg.qk_norm:
        for name in ("q_scale", "k_scale"):
            p[name] = torch.ones((hd,), dtype=dt, device=key.device)
    if cfg.cross_attention:
        p["xwq"] = dense_init(ks[4], D, H * hd, dt)
        p["xwk"] = dense_init(ks[5], D, Hkv * hd, dt)
        p["xwv"] = dense_init(ks[6], D, Hkv * hd, dt)
        p["xwo"] = dense_init(ks[7], H * hd, D, dt)
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


def _gqa_out(p, v):
    """p: (B,Hkv,G,T,S) float32, v: (B,S,Hkv,d) -> (B,T,Hkv,G,d); the
    probabilities are cast to v's dtype before the product."""
    return torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype), v)


def masked_attention(q, k, v, q_pos, kv_pos, *, scale, window=None,
                     causal=True):
    """Grouped attention, the reference's math.  q: (B,T,Hq,d), k/v:
    (B,S,Hkv,dv).  Scores in float32; the probabilities are cast to v's
    dtype before the product with V.  Dense for T <=
    ``CHUNKED_THRESHOLD``, chunked online softmax above it."""
    B, T, Hq, d = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, d)
    if T > CHUNKED_THRESHOLD:
        return _chunked_attention(qg, k, v, q_pos, kv_pos, scale, window,
                                  causal).to(q.dtype)
    bias = _mask_bias(q_pos, kv_pos, window, causal)            # (B,T,S)
    s = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float())
    s = s * scale + bias[:, None, None]
    s = constrain(s, "scores_seq")
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p, v).reshape(B, T, Hq, v.shape[-1])


def _kv_block(qi, qp, ki, vi, kp, m, l, o, scale, window, causal):
    """One (query chunk, key chunk) step of the online softmax: the
    running max ``m``, sum ``l`` and output ``o`` (B,Hkv,G,Qc,dv), all
    float32."""
    bias = _mask_bias(qp, kp, window, causal)                   # (B,Qc,Kc)
    s = torch.einsum("bthgd,bshd->bhgts", qi.float(), ki.float())
    s = s * scale + bias[:, None, None]
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(-1)
    o_new = o * alpha[..., None] + \
        _gqa_out(p, vi).float().permute(0, 2, 3, 1, 4)
    return m_new, l_new, o_new


def _q_block(qi, qp, kc, vc, kpc, scale, window, causal):
    """One query chunk against every key chunk -> (B,Qc,Hkv,G,dv) in
    q's dtype.  Each key step is recomputed in the backward."""
    B, Qc, Hkv, G, _ = qi.shape
    dv = vc[0].shape[-1]
    m = qi.new_full((B, Hkv, G, Qc), NEG_INF, dtype=torch.float32)
    l = qi.new_zeros((B, Hkv, G, Qc), dtype=torch.float32)
    o = qi.new_zeros((B, Hkv, G, Qc, dv), dtype=torch.float32)
    for ki, vi, kp in zip(kc, vc, kpc):
        m, l, o = checkpointed(records_grad(qi, ki, vi), _kv_block, qi,
                                qp, ki, vi, kp, m, l, o, scale, window,
                                causal)
    o = o / l.clamp_min(1e-30)[..., None]
    # cast before stacking, as the reference does
    return o.to(qi.dtype).permute(0, 3, 1, 2, 4)


def _chunked_attention(qg, k, v, q_pos, kv_pos, scale, window, causal):
    """The reference's chunked online softmax: Q_CHUNK query rows at a
    time against KV_CHUNK keys at a time, keys padded to a whole chunk
    with ``kv_pos = -1`` (masked).  qg: (B,T,Hkv,G,d)."""
    B, T, Hkv, G, d = qg.shape
    if T % Q_CHUNK:
        raise ValueError(f"T={T} not divisible by q-chunk {Q_CHUNK}")
    S = k.shape[1]
    if S % KV_CHUNK:
        pad = -(-S // KV_CHUNK) * KV_CHUNK - S
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    kc = k.split(KV_CHUNK, dim=1)
    vc = v.split(KV_CHUNK, dim=1)
    kpc = kv_pos.split(KV_CHUNK, dim=1)
    rec = records_grad(qg, k, v)
    out = [checkpointed(rec, _q_block, qi, qp, kc, vc, kpc, scale, window,
                         causal)
           for qi, qp in zip(qg.split(Q_CHUNK, dim=1),
                             q_pos.split(Q_CHUNK, dim=1))]
    o = torch.cat(out, dim=1)                       # (B,T,Hkv,G,dv)
    return o.reshape(B, T, Hkv * G, o.shape[-1])


def prefill_attention(q, k, v, window=None, k_shared=None):
    """Causal self-attention over the prompt through the flash kernel.
    q: (B,T,H,d), k/v: (B,T,Hkv,dv) -> (B,T,H,dv); k_shared: MLA's rope
    key (B,T,rp), K's last columns for every head.  Query head h reads
    KV head h // G (the reference's ``q.reshape(B, T, Hkv, G, d)``), in
    the kernel: nothing is copied around the call."""
    return flash_attention_heads(q, k, v, window=window, k_shared=k_shared)


# ---------------------------------------------------------------------------
# GQA block forward
# ---------------------------------------------------------------------------

def _proj(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b
    return y


def gqa_attention(cfg, p, x, q_pos, kv_pos, cache=None, positions3=None):
    """x: (B,T,D); cache: a layer's ``{"k","v": (B,Sc,Hkv,hd)}`` (with
    ``kv_quant``: int8, and ``"k_scale","v_scale": (B,Sc,Hkv)`` float32)
    or None; positions3: (B,T,3) with ``cfg.mrope``.

    Returns (out, cache).  With a cache, T == 1 decodes (this token's
    k/v go into its slot) and T > 1 prefills (the cache is rebuilt from
    the prompt's tail).  Unlike the reference, which returns a new
    cache, the port writes the given cache tensors in place and returns
    them.  Without a cache (the training forward, ``kv_pos = q_pos``)
    it returns (out, None)."""
    check_supported(cfg)
    B, T, D = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = constrain(_proj(x, p["wq"], p.get("bq")).reshape(B, T, H, hd),
                  "heads")
    k = constrain(_proj(x, p["wk"], p.get("bk")).reshape(B, T, Hkv, hd),
                  "kv")
    v = constrain(_proj(x, p["wv"], p.get("bv")).reshape(B, T, Hkv, hd),
                  "kv")
    if cfg.qk_norm:
        q = rms_norm_headwise(q, p["q_scale"])
        k = rms_norm_headwise(k, p["k_scale"])
    if cfg.pos_emb == "rope":
        if cfg.mrope:
            if positions3 is None:
                raise ValueError("an M-RoPE config needs positions3")
            cos, sin = mrope_cos_sin(positions3, hd, cfg.rope_theta)
        else:
            cos, sin = rope_cos_sin(q_pos, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    scale = 1.0 / math.sqrt(hd)

    if cache is not None and T == 1:
        # ---- decode: scatter this token's k/v into its slot ----
        slots = _cache_slots(cfg, q_pos, cache["k"].shape[1])   # (B,1)
        if cfg.kv_quant:
            for name, t in (("k", k), ("v", v)):
                qt, sc = _quantize_kv(t)
                _scatter_cache(cache[name], qt, slots)
                _scatter_cache(cache[name + "_scale"], sc, slots)
            ck = _dequantize_kv(cache["k"], cache["k_scale"], k.dtype)
            cv = _dequantize_kv(cache["v"], cache["v_scale"], v.dtype)
        else:
            ck = _scatter_cache(cache["k"], k, slots)
            cv = _scatter_cache(cache["v"], v, slots)
        o = masked_attention(q, ck, cv, q_pos, kv_pos, scale=scale,
                             window=cfg.sliding_window, causal=True)
    else:
        # ---- prefill / no-cache: causal attention over the sequence's
        # own keys; the kernel has no backward, so a recorded gradient
        # takes the reference's differentiable math ----
        if records_grad(q, k, v):
            o = masked_attention(q, k, v, q_pos, kv_pos, scale=scale,
                                 window=cfg.sliding_window, causal=True)
        else:
            o = prefill_attention(q, k, v, window=cfg.sliding_window)
        if cache is not None:   # prefill: the cache from the tail
            Sc = cache["k"].shape[1]
            for name, t in (("k", k), ("v", v)):
                if cfg.kv_quant:
                    t, sc = _quantize_kv(t)
                    cache[name + "_scale"].copy_(_tail_cache(sc, Sc))
                cache[name].copy_(_tail_cache(t, Sc))
    return o.reshape(B, T, H * hd) @ p["wo"], cache


def cross_attention(cfg, p, x, enc_kv):
    """Whisper's cross-attention.  x: (B,T,D); enc_kv: ``{"k","v":
    (B,Senc,Hkv,hd)}``.  Every encoder position is visible to every
    query (``kv_pos`` all zero, not causal), through the reference's
    plain math."""
    B, T, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q = (x @ p["xwq"]).reshape(B, T, H, hd)
    S = enc_kv["k"].shape[1]
    q_pos = torch.arange(T, device=x.device).expand(B, T)
    kv_pos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    o = masked_attention(q, enc_kv["k"], enc_kv["v"], q_pos, kv_pos,
                         scale=1.0 / math.sqrt(hd), causal=False)
    return o.reshape(B, T, H * hd) @ p["xwo"]


def encode_cross_kv(cfg, p, enc_out):
    """enc_out: (B,Senc,D) in the parameters' dtype -> ``{"k","v":
    (B,Senc,Hkv,hd)}``."""
    if enc_out.dtype != p["xwk"].dtype:
        raise ValueError(f"enc_out is {enc_out.dtype}, the parameters "
                         f"{p['xwk'].dtype}: cast it first (the serve "
                         "does)")
    B, S, _ = enc_out.shape
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": (enc_out @ p["xwk"]).reshape(B, S, Hkv, hd),
            "v": (enc_out @ p["xwv"]).reshape(B, S, Hkv, hd)}


def _cache_slots(cfg, q_pos, cache_len):
    if cfg.sliding_window is not None and cache_len <= cfg.sliding_window:
        return q_pos % cache_len  # ring buffer
    return q_pos


def _scatter_cache(cache, new, slots):
    """cache: (B,Smax,H,d); new: (B,T,H,d); slots: (B,T) int.  Writes in
    place and returns ``cache`` (the reference returns a new array)."""
    if is_sharded(cache):
        return write_slots(cache, new, slots)
    B, T = slots.shape
    b_idx = torch.arange(B, device=slots.device)[:, None].expand(B, T)
    cache[b_idx, slots.long()] = new.to(cache.dtype)
    return cache


def _quantize_kv(x):
    """x: (B,S,H,d) -> (int8 values, float32 scales (B,S,H)): symmetric
    over the head dim, rounded half to even (``jnp.round``)."""
    xf = x.float()
    sc = xf.abs().amax(-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / sc[..., None]).clamp(-127, 127).to(torch.int8)
    return q, sc


def _dequantize_kv(q, sc, dtype):
    return (q.float() * sc[..., None]).to(dtype)


def _tail_cache(k, Sc: int):
    """A (ring) cache holding the last ``Sc`` of ``k``: (B,S,...)."""
    S = k.shape[1]
    if Sc == S:
        return k
    if Sc > S:  # linear cache with free slots at the end
        pad = k.new_zeros((k.shape[0], Sc - S) + k.shape[2:])
        return torch.cat([k, pad], dim=1)
    tail = k[:, S - Sc:]
    # position p lives at slot p % Sc; tail index i is position S-Sc+i:
    # the roll by r = (S-Sc) % Sc, as two slices (DTensor has a strategy
    # for a cat on every torch release, for aten.roll not on 2.11)
    r = (S - Sc) % Sc
    if r == 0:
        return tail
    return torch.cat([tail[:, Sc - r:], tail[:, :Sc - r]], dim=1)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_attention(cfg, p, x, q_pos, kv_pos, cache=None):
    """Multi-head latent attention.  x: (B,T,D); cache: a layer's
    ``{"ckv": (B,Sc,kv_lora), "kr": (B,Sc,rope_head_dim)}`` (a linear
    cache) or None.  Returns (out, cache), the cache written in place as
    in :func:`gqa_attention`.

    T > 1 or no cache: per-head K/V from the latent and causal attention
    over the sequence (the prefill writes the latent cache from it).
    T == 1 with a cache: the absorbed decode, scores and values in the
    latent space, with the reference's cast points: ``q_lat`` in the
    parameters' dtype, float32 scores, the probabilities cast to the
    cache's dtype before the product with it."""
    check_supported(cfg)
    B, T, D = x.shape
    H = cfg.num_heads
    nope, rp, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head
    lora = cfg.kv_lora_rank

    cq = rms_norm_headwise(x @ p["wq_a"], p["q_norm"])
    q = (cq @ p["wq_b"]).reshape(B, T, H, nope + rp)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv_full = x @ p["wkv_a"]                          # (B,T,lora+rp)
    ckv = rms_norm_headwise(ckv_full[..., :lora], p["kv_norm"])
    cos, sin = rope_cos_sin(q_pos, rp, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(ckv_full[..., None, lora:], cos, sin)   # (B,T,1,rp)
    # the scale of q.k's width, nope + rp: what flash attention takes
    # from q's last dim
    scale = 1.0 / math.sqrt(nope + rp)

    if cache is None or T > 1:
        k_nope = (ckv @ p["wk_b"]).reshape(B, T, H, nope)
        v = constrain((ckv @ p["wv_b"]).reshape(B, T, H, dv), "heads")
        if records_grad(q, k_nope, v, k_rope):
            k = constrain(torch.cat([k_nope, k_rope.expand(B, T, H, rp)],
                                    -1), "heads")
            qf = constrain(torch.cat([q_nope, q_rope], -1), "heads")
            o = masked_attention(qf, k, v, q_pos, q_pos, scale=scale,
                                 window=cfg.sliding_window, causal=True)
        else:
            # q's rope columns rotated in its own buffer; the one rope key
            # of a position read by every head
            q[..., nope:] = q_rope
            o = prefill_attention(constrain(q, "heads"),
                                  constrain(k_nope, "heads"), v,
                                  window=cfg.sliding_window,
                                  k_shared=k_rope[:, :, 0])
        if cache is not None:   # prefill: the latent cache
            Sc = cache["ckv"].shape[1]
            if Sc < T:
                raise ValueError(f"MLA prefill of {T} tokens is longer "
                                 f"than the linear cache of {Sc}")
            cache["ckv"].copy_(_tail_cache(ckv, Sc))
            cache["kr"].copy_(_tail_cache(k_rope[:, :, 0], Sc))
        return o.reshape(B, T, H * dv) @ p["wo"], cache

    # ---- absorbed decode: this token's latent into its slot ----
    c_ckv = _scatter_cache(cache["ckv"], ckv, q_pos)   # linear cache
    c_kr = _scatter_cache(cache["kr"], k_rope[:, :, 0], q_pos)
    wk_b = p["wk_b"].reshape(lora, H, nope)
    wv_b = p["wv_b"].reshape(lora, H, dv)
    q_lat = torch.einsum("bthn,lhn->bthl", q_nope, wk_b)    # (B,T,H,lora)
    s_lat = torch.einsum("bthl,bsl->bhts", q_lat.float(), c_ckv.float())
    s_rope = torch.einsum("bthr,bsr->bhts", q_rope.float(), c_kr.float())
    bias = _mask_bias(q_pos, kv_pos, cfg.sliding_window, True)
    s = (s_lat + s_rope) * scale + bias[:, None]
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhts,bsl->bthl", pr.to(c_ckv.dtype), c_ckv)
    o = torch.einsum("bthl,lhv->bthv", o_lat, wv_b)
    return o.reshape(B, T, H * dv) @ p["wo"], cache
