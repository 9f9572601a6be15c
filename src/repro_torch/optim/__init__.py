"""Optimizers on dict trees of tensors: SGD (the paper's), momentum and
Adam, plus gradient clipping and LR schedules — the reference's
``repro.optim``.

An :class:`Optimizer` is a pair of functions, ``init(params) -> state``
and ``update(grads, state, params) -> (new params, new state)``; every
update is out of place.  ``state["step"]`` is a 0-d int32 tensor on the
parameters' device, and ``lr`` is a number or a schedule ``step ->
lr``.  A number multiplies a tensor as jax's weakly typed scalars do:
rounded to the tensor's dtype first (a bfloat16 leaf's step is
``bf16(lr) * g``, not ``float32(lr) * g`` rounded once).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..models.transformer import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params)


def _device(tree):
    return tree_leaves(tree)[0].device


def _weak(x, t):
    """A Python number as a jax weak type against ``t``: rounded to
    ``t``'s dtype (a tensor, such as a schedule's value, is kept)."""
    if torch.is_tensor(x):
        return x
    return float(torch.tensor(x, dtype=t.dtype))


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _step0(params):
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def sgd(lr) -> Optimizer:
    """Plain SGD (paper's eq. (1), constant eta).  No optimizer memory."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params):
        step = state["step"]
        eta = lr_fn(step)
        new = tree_map(lambda p, g: p - _weak(eta, p) * g.to(p.dtype),
                       params, grads)
        return new, {"step": step + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"step": _step0(params), "m": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        m = tree_map(lambda m_, g: _weak(beta, m_) * m_ + g.to(m_.dtype),
                     state["m"], grads)
        eta = lr_fn(state["step"])
        new = tree_map(lambda p, m_: p - _weak(eta, p) * m_.to(p.dtype),
                       params, m)
        return new, {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def zeros32(p):
        return torch.zeros_like(p, dtype=torch.float32)

    def init(params):
        return {"step": _step0(params), "m": tree_map(zeros32, params),
                "v": tree_map(zeros32, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                 state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(),
                 state["v"], grads)
        eta = lr_fn(step)
        sf = step.float()
        bc1 = 1 - torch.pow(b1, sf)
        bc2 = 1 - torch.pow(b2, sf)

        def upd(p, m_, v_):
            mh = m_ / bc1
            vh = v_ / bc2
            return p - (eta * mh / (torch.sqrt(vh) + eps)).to(p.dtype)

        return tree_map(upd, params, m, v), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping); the norm sums the leaves in float32."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / norm.clamp_min(1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return lr


def get_optimizer(name: str, lr) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adam": adam}[name](lr)
