"""Feed-forward blocks: SwiGLU (silu) and the plain GELU MLP — plus
:class:`MLPClassifier`, the registry's flatten -> ReLU-stack federated
client model."""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import rng
from .layers import act_fn, dense_init, dtype_of


def init_mlp(cfg, key, d_ff=None):
    dt = dtype_of(cfg)
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    k1, k2, k3 = rng.split(key, 3).unbind(0)
    if cfg.mlp_act == "gelu":
        return {"w1": dense_init(k1, D, F, dt), "w2": dense_init(k2, F, D, dt)}
    return {
        "w1": dense_init(k1, D, F, dt),   # up
        "w3": dense_init(k3, D, F, dt),   # gate
        "w2": dense_init(k2, F, D, dt),   # down
    }


def mlp(cfg, p, x):
    act = act_fn(cfg.mlp_act)
    if "w3" in p:  # SwiGLU
        return (act(x @ p["w3"]) * (x @ p["w1"])) @ p["w2"]
    return act(x @ p["w1"]) @ p["w2"]


class MLPClassifier:
    """Flatten -> ReLU hidden stack -> logits, with the CNN's contract
    (``init``, ``apply``, ``apply_stacked``, ``num_params``).  Parameters
    are ``{"layer{i}": {"w" (fan_in, fan_out), "b" (fan_out,)}}``, the
    reference's layout."""

    def __init__(self, num_classes: int, input_shape: tuple,
                 hidden: tuple = (64, 64)):
        self.num_classes = num_classes
        self.input_shape = tuple(int(s) for s in input_shape)
        self.hidden = tuple(int(h) for h in hidden)
        self.dims = (math.prod(self.input_shape), *self.hidden, num_classes)

    def init(self, key):
        """Parameters from ``key`` (the reference's draws, on the key's
        device)."""
        keys = rng.split(key, len(self.dims) - 1)
        params = {}
        for i, (fan_in, fan_out) in enumerate(zip(self.dims[:-1],
                                                  self.dims[1:])):
            w = rng.normal(keys[i], (fan_in, fan_out))
            scale = torch.sqrt(torch.tensor(float(fan_in))).to(key.device)
            params[f"layer{i}"] = {
                "w": w / scale,
                "b": torch.zeros(fan_out, device=key.device)}
        return params

    def apply_stacked(self, params, x):
        """Device-stacked forward: params leaves (D, ...), x (D, B,
        *input_shape) -> logits (D, B, num_classes), one ``baddbmm`` a
        layer."""
        if tuple(x.shape[2:]) != self.input_shape:
            raise ValueError(
                f"MLPClassifier built for input shape {self.input_shape} "
                f"but got a batch of shape {tuple(x.shape[2:])}")
        h = x.reshape(x.shape[0], x.shape[1], -1)
        n = len(self.dims) - 1
        for i in range(n):
            layer = params[f"layer{i}"]
            h = torch.baddbmm(layer["b"][:, None, :], h, layer["w"])
            if i < n - 1:
                h = torch.relu(h)
        return h

    def apply(self, params, x):
        """Single model: x (B, *input_shape) -> logits (B, num_classes)."""
        stacked = {k: {n: t[None] for n, t in v.items()}
                   for k, v in params.items()}
        return self.apply_stacked(stacked, x[None])[0]

    @staticmethod
    def num_params(params) -> int:
        return sum(t.numel() for v in params.values() for t in v.values())


def from_jax_params(params_np, device="cpu"):
    """Reference MLPClassifier parameters (numpy arrays) -> the port's
    dict; the layout is the same, leading device axes carry over."""
    return {name: {n: torch.tensor(np.asarray(t), device=device)
                   for n, t in leaf.items()}
            for name, leaf in params_np.items()}


def to_jax_params(params):
    """Inverse of :func:`from_jax_params`: numpy arrays."""
    return {name: {n: t.detach().cpu().numpy() for n, t in leaf.items()}
            for name, leaf in params.items()}
