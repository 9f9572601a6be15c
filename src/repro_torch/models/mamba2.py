"""Mamba2 mixer: SSD (state-space duality) with a chunked scan.

Semantics (per head h, state N, head-dim P):
    h_t = exp(A_h * dt_t) h_{t-1} + dt_t * B_t x_t^T
    y_t = C_t . h_t + D_h x_t

The chunked SSD (:func:`ssd_chunked`) goes through the SSD scan kernel
(:func:`repro_torch.kernels.ssd_scan.ssd_scan_heads`,
``csrc/ssd_scan.cu``) for CUDA tensors when autograd records nothing (the
kernel has no backward), on the mixer's x, dt, B and C as they are (in
the models' layout; dt folded into the kernel), and returns y in that
layout and the final state that the cache-building prefill hands to
decode.  For CPU tensors, and when a gradient is being recorded
(training), it is the reference's ``ssd_chunked``, einsum for einsum.
The single-token decode is plain PyTorch, as the reference's is plain
jnp.  Unlike the reference, which returns a new cache, the port writes
the given cache tensors in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import rng
from ..kernels.runtime import (is_sharded, on_cuda, on_local_rows,
                               records_grad, shapes_only)
from ..kernels.ssd_scan import ssd_scan_heads
from .layers import dense_init, dtype_of
from .shardhooks import constrain


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def init_mamba(cfg, key):
    dt = dtype_of(cfg)
    D, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    Cd = conv_dim(cfg)
    ks = rng.split(key, 4).unbind(0)
    dev = key.device
    return {
        "in_proj": dense_init(ks[0], D, 2 * di + 2 * cfg.ssm_ngroups *
                              cfg.ssm_state + H, dt),
        "conv_w": (rng.normal(ks[1], (cfg.ssm_conv, Cd))
                   / math.sqrt(cfg.ssm_conv)).to(dt),
        "conv_b": torch.zeros((Cd,), dtype=dt, device=dev),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "norm": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": dense_init(ks[2], di, D, dt),
    }


def _causal_conv(xBC, w, b):
    """Depthwise causal conv. xBC: (B,S,Cd); w: (k,Cd)."""
    k = w.shape[0]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    S = xBC.shape[1]
    y = sum(pad[:, i:i + S, :] * w[i] for i in range(k))
    return y + b


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD. x: (B,S,H,P) fp32, dt: (B,S,H), A: (H,),
    Bm/Cm: (B,S,G,N). Returns (y (B,S,H,P), final_state (B,H,N,P)).
    Sharded operands: each rank's batch rows on their own (the heads
    gathered: B and C are shared by a group's heads)."""
    init = () if initial_state is None else (initial_state,)
    if is_sharded(x):
        A = A.full_tensor() if is_sharded(A) else A
        return on_local_rows(_ssd_rows, x, dt, Bm, Cm, *init, A=A,
                             chunk=chunk)
    if not records_grad(x, dt, A, Bm, Cm, *init) and (
            shapes_only(x, dt, A, Bm, Cm, *init)
            or on_cuda(x, dt, A, Bm, Cm, *init)):
        return _ssd_chunked_scan(x, dt, A, Bm, Cm, chunk, initial_state)
    return _ssd_chunked_plain(x, dt, A, Bm, Cm, chunk, initial_state)


def _ssd_rows(x, dt, Bm, Cm, *init, A, chunk):
    return ssd_chunked(x, dt, A, Bm, Cm, chunk, *init)


def _ssd_chunked_scan(x, dt, A, Bm, Cm, chunk, initial_state=None):
    """Through the SSD scan kernel in the models' layout: query head h
    reads group h // (H // G) (the reference's ``jnp.repeat``), dt is
    folded into the kernel, and y comes back (B, S, H, P) as written."""
    init = None if initial_state is None else initial_state.contiguous()
    return ssd_scan_heads(x, dt, A, Bm, Cm, chunk, init, final=True)


def _ssd_chunked_plain(x, dt, A, Bm, Cm, chunk, initial_state=None):
    """The reference's ``ssd_chunked`` in PyTorch (its lax.scan over the
    chunks a Python loop)."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=2)  # (B,S,H,N)
    Ch = Cm.repeat_interleave(rep, dim=2)
    dA = dt * A  # (B,S,H), <= 0
    xdt = x * dt[..., None]

    nc = S // chunk
    if S % chunk:
        raise ValueError(f"S={S} not divisible by chunk {chunk}")
    L = chunk

    def rs(t):
        return t.reshape((B_, nc, L) + t.shape[2:])

    xc, dAc, Bc, Cc = rs(xdt), rs(dA), rs(Bh), rs(Ch)

    seg = torch.cumsum(dAc, dim=2)  # (B,nc,L,H) inclusive
    # ---- intra-chunk (attention-like) ----
    decay = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # (B,nc,L,L,H)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    att = torch.exp(torch.where(causal[None, None, :, :, None], decay,
                                float("-inf")))
    CB = torch.einsum("bclhn,bcmhn->bclmh", Cc, Bc)
    y_intra = torch.einsum("bclmh,bclmh,bcmhp->bclhp", CB, att, xc)

    # ---- per-chunk end states ----
    decay_last = torch.exp(seg[:, :, -1:, :] - seg)  # (B,nc,L,H)
    states = torch.einsum("bclh,bclhn,bclhp->bchnp", decay_last, Bc, xc)

    # ---- inter-chunk recurrence over nc ----
    chunk_decay = torch.exp(seg[:, :, -1, :])  # (B,nc,H)
    s = (initial_state if initial_state is not None
         else torch.zeros((B_, H, N, P), dtype=x.dtype, device=x.device))
    prev = []  # the state *entering* each chunk
    for c in range(nc):
        prev.append(s)
        s = chunk_decay[:, c, :, None, None] * s + states[:, c]
    prev = torch.stack(prev, dim=1)  # (B,nc,H,N,P)

    y_inter = torch.einsum("bclh,bclhn,bchnp->bclhp", torch.exp(seg), Cc,
                           prev)
    y = (y_intra + y_inter).reshape(B_, S, H, P)
    return y, s


def mamba2_forward(cfg, p, x, cache=None, dtype=torch.float32):
    """x: (B,S,D). cache: a layer's {"state": (B,H,N,P), "conv":
    (B,k-1,Cd)} or None.  With a cache, S == 1 decodes and S > 1 is the
    cache-building prefill; the cache's tensors are written in place.
    ``dtype``: the mixer's compute dtype between the projections, float32
    as in the reference (float64 gives the tests an oracle for the CPU
    path).  Returns (out, cache)."""
    B_, S, D = x.shape
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    GN = G * N

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * GN]
    dt_raw = zxbcdt[..., -H:].to(dtype)
    dt = F.softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(dtype))

    if cache is None or S > 1:
        conv_in = xBC
        xBC = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
        xs = constrain(xBC[..., :di].to(dtype).reshape(B_, S, H, P),
                       "ssm_inner")
        Bm = xBC[..., di:di + GN].to(dtype).reshape(B_, S, G, N)
        Cm = xBC[..., di + GN:].to(dtype).reshape(B_, S, G, N)
        chunk = min(cfg.ssm_chunk, S)
        if S % chunk:  # pad with dt=0 steps: state passes through unchanged
            pad = -(-S // chunk) * chunk - S

            def zpad(t):
                return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

            ys, final = ssd_chunked(zpad(xs), zpad(dt), A, zpad(Bm),
                                    zpad(Cm), chunk)
            y = ys[:, :S]
        else:
            y, final = ssd_chunked(xs, dt, A, Bm, Cm, chunk)
        if cache is not None:  # prefill: hand the state to decode
            k = cfg.ssm_conv
            if S < k - 1:
                raise ValueError(f"a prefill of {S} tokens does not fill "
                                 f"the conv cache of {k - 1}")
            cache["state"].copy_(final)
            cache["conv"].copy_(conv_in[:, S - (k - 1):, :])
    else:
        # ---- single-token decode ----
        window = torch.cat([cache["conv"], xBC], dim=1)  # (B,k,Cd)
        conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + \
            p["conv_b"]
        xBC1 = F.silu(conv_out)[:, None, :]  # (B,1,Cd)
        xs = xBC1[..., :di].to(dtype).reshape(B_, 1, H, P)
        Bm = xBC1[..., di:di + GN].to(dtype).reshape(B_, 1, G, N)
        Cm = xBC1[..., di + GN:].to(dtype).reshape(B_, 1, G, N)
        rep = H // G
        Bh = Bm[:, 0].repeat_interleave(rep, dim=1)  # (B,H,N)
        Ch = Cm[:, 0].repeat_interleave(rep, dim=1)
        a = torch.exp(dt[:, 0] * A)  # (B,H)
        xdt = xs[:, 0] * dt[:, 0, :, None]  # (B,H,P)
        state = cache["state"].to(dtype)
        state = a[..., None, None] * state + \
            torch.einsum("bhn,bhp->bhnp", Bh, xdt)
        y = torch.einsum("bhn,bhnp->bhp", Ch, state)[:, None]  # (B,1,H,P)
        cache["state"].copy_(state)
        cache["conv"].copy_(window[:, 1:])

    y = y + p["D"][:, None] * xs
    y = y.reshape(B_, S, di)

    # gated RMSNorm
    g = y * F.silu(z.to(dtype))
    ms = torch.mean(torch.square(g), dim=-1, keepdim=True)
    g = g * torch.rsqrt(ms + cfg.norm_eps) * p["norm"].to(dtype)
    out = g.to(x.dtype) @ p["out_proj"]
    return out, cache
