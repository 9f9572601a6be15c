"""The paper's on-device model: 3-layer CNN (2 conv + 1 FC), ~12.5k weights.

conv 1->14 3x3 SAME, max-pool 2, conv 14->20 3x3 SAME, max-pool 2, fc
980->10 (12,490 parameters on 28x28x1 digits; configs/paper_cnn.py).

Parameters are a dict of tensors, ``{"conv1": {"w", "b"}, "conv2": ...,
"fc": ...}``, with conv weights in PyTorch's OIHW and the FC weight as
``(fc_in, C)`` whose rows follow the reference's NHWC flatten order.
Images stay NHWC at the public functions, as in the reference.

:meth:`CNN.apply_stacked` runs a whole device population at once: every
leaf carries a leading device axis ``(D, ...)``, the conv layers run as
one grouped convolution (``groups=D``) and the FC layer as one ``bmm``.
That replaces the reference's ``jax.vmap`` over devices.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import rng
from ..configs.paper_cnn import (CONV_CHANNELS, IMAGE_SIZE, KERNEL,
                                 NUM_CLASSES, POOL)


def _conv_init(key, k, cin, cout):
    scale = 1.0 / torch.sqrt(torch.tensor(float(k * k * cin)))
    w = rng.normal(key, (k, k, cin, cout)) * scale.to(key.device)
    return w.permute(3, 2, 0, 1).contiguous()       # HWIO -> OIHW


class CNN:
    """Functional CNN: a params dict + pure apply.  Input (B, H, W, C)."""

    def __init__(self, num_classes: int = NUM_CLASSES,
                 input_shape: tuple = (IMAGE_SIZE, IMAGE_SIZE, 1)):
        if len(input_shape) != 3:
            raise ValueError(
                f"CNN input_shape must be (H, W, C), got {input_shape}")
        self.num_classes = num_classes
        self.input_shape = tuple(int(s) for s in input_shape)
        h, w, _ = self.input_shape
        # two VALID pool-2 stages: floor division per stage
        self.fc_in = (h // POOL // POOL) * (w // POOL // POOL) * \
            CONV_CHANNELS[1]
        if self.fc_in == 0:
            raise ValueError(
                f"input_shape {self.input_shape} too small for two "
                f"pool-{POOL} stages")

    def init(self, key):
        """Parameters from ``key`` (the reference's draws, on the key's
        device)."""
        k1, k2, k3 = rng.split(key, 3).unbind(0)
        c1, c2 = CONV_CHANNELS
        cin = self.input_shape[2]
        dev = key.device
        fc_scale = torch.sqrt(torch.tensor(float(self.fc_in))).to(dev)
        return {
            "conv1": {"w": _conv_init(k1, KERNEL, cin, c1),
                      "b": torch.zeros(c1, device=dev)},
            "conv2": {"w": _conv_init(k2, KERNEL, c1, c2),
                      "b": torch.zeros(c2, device=dev)},
            "fc": {"w": rng.normal(k3, (self.fc_in, self.num_classes))
                   / fc_scale,
                   "b": torch.zeros(self.num_classes, device=dev)},
        }

    def apply_stacked(self, params, x):
        """Device-stacked forward: params leaves (D, ...), x (D, B, H, W,
        C) -> logits (D, B, num_classes)."""
        if tuple(x.shape[2:]) != self.input_shape:
            raise ValueError(
                f"CNN built for input shape {self.input_shape} but got a "
                f"batch of shape {tuple(x.shape[2:])}")
        d, b = x.shape[:2]
        h, w, cin = self.input_shape
        # (D, B, H, W, C) -> (B, D*C, H, W): device d owns channel group d
        h_ = x.permute(1, 0, 4, 2, 3).reshape(b, d * cin, h, w)
        for name in ("conv1", "conv2"):
            p = params[name]
            wt = p["w"].reshape((-1,) + tuple(p["w"].shape[2:]))
            h_ = F.conv2d(h_, wt, p["b"].reshape(-1), padding=KERNEL // 2,
                          groups=d)
            h_ = F.max_pool2d(F.relu(h_), POOL)
        c2 = CONV_CHANNELS[1]
        # back to the reference's NHWC flatten order before the FC layer
        h_ = h_.reshape(b, d, c2, h_.shape[2], h_.shape[3])
        h_ = h_.permute(1, 0, 3, 4, 2).reshape(d, b, -1)
        return torch.baddbmm(params["fc"]["b"][:, None, :], h_,
                             params["fc"]["w"])

    def apply(self, params, x):
        """Single model: x (B, H, W, C) -> logits (B, num_classes)."""
        stacked = {k: {n: t[None] for n, t in v.items()}
                   for k, v in params.items()}
        return self.apply_stacked(stacked, x[None])[0]

    @staticmethod
    def num_params(params) -> int:
        return sum(t.numel() for v in params.values() for t in v.values())


def from_jax_params(params_np, device="cpu"):
    """Reference parameter pytree (numpy arrays, HWIO conv weights) ->
    the port's dict (OIHW conv weights).  Leading device axes carry
    over."""
    out = {}
    for name, leaf in params_np.items():
        w = torch.tensor(np.asarray(leaf["w"]), device=device)
        if name.startswith("conv"):
            nd = w.dim()
            w = w.permute(*range(nd - 4), nd - 1, nd - 2, nd - 4, nd - 3)
        out[name] = {"w": w.contiguous(),
                     "b": torch.tensor(np.asarray(leaf["b"]),
                                       device=device)}
    return out


def to_jax_params(params):
    """Inverse of :func:`from_jax_params`: numpy arrays, HWIO convs."""
    out = {}
    for name, leaf in params.items():
        w = leaf["w"].detach().cpu()
        if name.startswith("conv"):
            nd = w.dim()
            w = w.permute(*range(nd - 4), nd - 2, nd - 1, nd - 3, nd - 4)
        out[name] = {"w": np.ascontiguousarray(w.numpy()),
                     "b": leaf["b"].detach().cpu().numpy()}
    return out
