"""Synthetic data (the reference is offline: no MNIST download).

``synthetic_images`` is the 10-class 28x28 'digit' task: each class is a
smooth random prototype (a coarse Gaussian grid upsampled bilinearly)
plus per-sample noise and a random shift; |S_d| = 500 and b_s = 8 bit x
28 x 28 follow Sec. IV.  ``synthetic_tokens`` are the Markov-ish token
streams of the LM serve prompts.  Both draw from :mod:`repro_torch.rng`,
so a key gives the reference's arrays."""
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


def synthetic_tokens(key, n_seqs: int, seq_len: int, vocab: int,
                     order: int = 2, device=None):
    """Markov-ish token streams (n_seqs, seq_len) int64 on ``device``
    (default: the GPU): the next token is a random linear hash of the
    previous ``order`` tokens plus a draw from {0, 1, 2}, mod vocab.  The
    draws are bit-exact with the reference's."""
    key = key.to(resolve_device(device))
    k1, k2 = rng.split(key, 2).unbind(0)
    coefs = rng.randint(k1, (order,), 1, 97)
    seq_keys = rng.split(k2, n_seqs)                         # (n, 2)
    ks = rng.split(seq_keys, 2)                              # (n, 2, 2)
    prev = rng.randint(ks[:, 0], (order,), 0, vocab)         # (n, order)
    noise = rng.randint(rng.split(ks[:, 1], seq_len), (), 0, 3)  # (n, T)
    out = []
    for t in range(seq_len):
        nxt = ((prev * coefs).sum(-1) % vocab + noise[:, t]) % vocab
        prev = torch.cat([prev[:, 1:], nxt[:, None]], dim=1)
        out.append(nxt)
    if not out:
        return torch.zeros((n_seqs, 0), dtype=torch.int64,
                           device=key.device)
    return torch.stack(out, dim=1)
