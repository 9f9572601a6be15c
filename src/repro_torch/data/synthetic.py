"""The synthetic 10-class 28x28 'digit' task (the reference is offline:
no MNIST download).  Each class is a smooth random prototype (a coarse
Gaussian grid upsampled bilinearly) plus per-sample noise and a random
shift; |S_d| = 500 and b_s = 8 bit x 28 x 28 follow Sec. IV.  Drawn
from :mod:`repro_torch.rng`, so a key gives the reference's arrays."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import rng
from ..device import resolve_device


def _class_prototypes(key, num_classes: int, side: int):
    """Low-frequency prototypes: random 7x7 grids upsampled (half-pixel
    bilinear, as ``jax.image.resize``) and scaled to max |value| 1."""
    coarse = rng.normal(key, (num_classes, 7, 7))
    up = F.interpolate(coarse[:, None], size=(side, side), mode="bilinear",
                       align_corners=False)[:, 0]
    return up / up.abs().amax(dim=(1, 2), keepdim=True)


def synthetic_images(key, n: int, num_classes: int = 10, side: int = 28,
                     noise: float = 0.35, device=None):
    """Returns (x (n, side, side, 1) float32 in [0, 1], y (n,) int64) on
    ``device`` (default: the GPU)."""
    key = key.to(resolve_device(device))
    kp, ky, kn, ks = rng.split(key, 4).unbind(0)
    protos = _class_prototypes(kp, num_classes, side)
    y = rng.randint(ky, (n,), 0, num_classes)
    jitter = rng.normal(kn, (n, side, side)) * noise
    img = protos[y] + jitter
    # per-sample roll: out[r, c] = img[(r - s0) % side, (c - s1) % side]
    shifts = rng.randint(ks, (n, 2), -2, 3)
    ar = torch.arange(side, device=key.device)
    rows = (ar[None, :] - shifts[:, :1]) % side            # (n, side)
    cols = (ar[None, :] - shifts[:, 1:]) % side
    img = img[torch.arange(n, device=key.device)[:, None, None],
              rows[:, :, None], cols[:, None, :]]
    x = torch.sigmoid(2.0 * img)  # squash to (0,1) ~ pixel intensities
    return x[..., None].to(torch.float32), y
