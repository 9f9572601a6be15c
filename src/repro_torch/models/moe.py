"""Mixture-of-Experts layer, GShard-style grouped dense dispatch (the
reference's ``models/moe.py``).

Tokens are reshaped into groups of (at most) ``moe_group_size``; within
each group a capacity-limited one-hot dispatch/combine einsum routes
tokens to experts.  Shared experts (Qwen2-MoE style) run as a fused
dense SwiGLU over all tokens.  The expert and shared products are plain
matrix products (the reference has no kernel for them).

Where the port keeps the reference's numerics exactly, since a
difference would change which experts a token takes:

- the router's logits are the product of the bf16-rounded operands
  accumulated in float32 and never rounded to bf16 (the reference's
  ``einsum(..., preferred_element_type=float32)``); a bf16 product
  would round them and change top-k picks;
- top-k breaks ties by the lower expert index (``jax.lax.top_k``), here
  through a stable descending sort;
- each (token, k)'s place in its expert's queue is the exclusive cumsum
  over the flattened (Sg * K) order, in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import rng
from .layers import dense_init, dtype_of, scaled_normal
from .shardhooks import constrain


def init_moe(cfg, key):
    dt = dtype_of(cfg)
    D, E, Fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    ks = rng.split(key, 6).unbind(0)
    scale = 1.0 / math.sqrt(D)
    p = {"router": dense_init(ks[0], D, E, torch.float32),  # router in f32
         "w1": scaled_normal(ks[1], (E, D, Fe), scale, dt),
         "w3": scaled_normal(ks[2], (E, D, Fe), scale, dt),
         "w2": _over_sqrt(ks[3], (E, Fe, D), Fe, dt)}
    if cfg.num_shared_experts:
        Fs = cfg.num_shared_experts * cfg.moe_d_ff
        p["shared"] = {"w1": dense_init(ks[4], D, Fs, dt),
                       "w3": dense_init(ks[5], D, Fs, dt),
                       "w2": dense_init(rng.fold_in(ks[4], 7), Fs, D, dt)}
    return p


def _over_sqrt(key, shape, n: int, dtype):
    """``(jax.random.normal(key, shape, f32) / sqrt(n)).astype(dtype)``:
    the divisor a float32 tensor (a Python scalar may become a product
    with its reciprocal, which rounds otherwise)."""
    w = scaled_normal(key, shape, 1.0, torch.float32)
    w /= torch.full((1,), math.sqrt(n), device=w.device)
    return w.to(dtype)


def capacity(cfg, group_size: int) -> int:
    c = int(math.ceil(group_size * cfg.top_k * cfg.capacity_factor
                      / cfg.num_experts))
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def group_size(cfg, T: int) -> int:
    """The largest group size <= ``moe_group_size`` dividing T."""
    Sg = min(cfg.moe_group_size, T)
    while T % Sg:
        Sg -= 1
    return Sg


def route(cfg, router, xg):
    """Router probabilities (G,Sg,E) float32 and the top-k gates and
    expert indices (G,Sg,K), lower index first among equal
    probabilities.  The logits accumulate the bf16-rounded operands in
    float32 without rounding the result."""
    logits = xg.float() @ router.to(xg.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, vals[..., :cfg.top_k], idx[..., :cfg.top_k]


def moe_ffn(cfg, p, x):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux_loss float32)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    Sg = group_size(cfg, T)
    G = T // Sg
    xg = x.reshape(G, Sg, D)

    probs, gate_vals, top_idx = route(cfg, p["router"], xg)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch-style auxiliary load-balance loss
    onehot = F.one_hot(top_idx, E).float()                        # (G,Sg,K,E)
    me = probs.mean(dim=(0, 1))                                   # (E,)
    ce = onehot.sum(2).mean(dim=(0, 1))                           # (E,)
    aux = cfg.router_aux_weight * E * (me * ce).sum()

    C = capacity(cfg, Sg)
    # position of each (token, k) within its expert queue, counted over
    # the flattened (Sg*K) order
    flat = onehot.reshape(G, Sg * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, Sg, K, E)
    in_cap = (pos < C).float() * onehot
    pos_idx = (pos * onehot).sum(-1).to(torch.int64)              # (G,Sg,K)
    # jax.nn.one_hot: a dropped place (>= C) is a row of zeros
    cap_oh = (pos_idx[..., None] == torch.arange(C, device=x.device)).float()
    # combine[g,s,e,c] = gate * kept * onehot(e) * onehot(c): a token
    # takes an expert at most once, so one k adds to each (e, c)
    combine = torch.einsum("gske,gskc->gsec", gate_vals[..., None] * in_cap,
                           cap_oh)                                # (G,Sg,E,C)
    combine = constrain(combine, "combine")
    dispatch = (combine > 0).to(x.dtype)

    xe = constrain(torch.einsum("gsec,gsd->gecd", dispatch, xg),
                   "dispatched")                                  # (G,E,C,D)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w3"])) * \
        torch.einsum("gecd,edf->gecf", xe, p["w1"])
    ye = constrain(torch.einsum("gecf,efd->gecd", h, p["w2"]), "dispatched")
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)

    y = y.reshape(B, S, D)
    if "shared" in p:
        sp = p["shared"]
        y = y + (F.silu(x @ sp["w3"]) * (x @ sp["w1"])) @ sp["w2"]
    return y, aux
