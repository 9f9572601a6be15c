"""Synthetic data (the reference is offline: no MNIST/CIFAR download).

``synthetic_images`` is the 10-class 28x28 'digit' task: each class is a
smooth random prototype (a coarse Gaussian grid upsampled bilinearly)
plus per-sample noise and a random shift; |S_d| = 500 and b_s = 8 bit x
28 x 28 follow Sec. IV.  ``synthetic_rgb_images`` (32x32x3) and
``synthetic_audio`` (32x40x1, 12 classes) follow the same recipe for the
cifar and speech tasks.  ``synthetic_tokens`` are the Markov-ish token
streams of the LM serve prompts.  All draw from :mod:`repro_torch.rng`,
so a key gives the reference's arrays."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import rng
from ..device import resolve_device


def _upsample(coarse, size):
    """Half-pixel bilinear upsampling, as ``jax.image.resize``: coarse
    (N, h, w[, C]) -> (N, *size[, C]), each axis scaled on its own; the
    trailing channel axis, where there is one, is kept."""
    chan = coarse.dim() == 4
    img = coarse.permute(0, 3, 1, 2) if chan else coarse[:, None]
    up = F.interpolate(img, size=tuple(size), mode="bilinear",
                       align_corners=False)
    return up.permute(0, 2, 3, 1) if chan else up[:, 0]


def _prototypes(key, coarse_shape, size):
    """Low-frequency class prototypes: random coarse grids upsampled and
    scaled to max |value| 1 per class."""
    up = _upsample(rng.normal(key, coarse_shape), size)
    return up / up.abs().amax(dim=tuple(range(1, up.dim())), keepdim=True)


def _roll(img, s0, s1=None):
    """Per-sample roll of (n, H, W, ...) along H by s0 (n,) and, where
    given, along W by s1 (n,): out[r, c] = img[(r - s0) % H, (c - s1) % W]."""
    n, h, w = img.shape[:3]
    dev = img.device
    rows = (torch.arange(h, device=dev)[None, :] - s0[:, None]) % h
    cols = torch.arange(w, device=dev)[None, :].expand(n, w)
    if s1 is not None:
        cols = (cols - s1[:, None]) % w
    return img[torch.arange(n, device=dev)[:, None, None],
               rows[:, :, None], cols[:, None, :]]


def _draws(key, device):
    """The four keys of a task generator, on ``device``."""
    return rng.split(key.to(resolve_device(device)), 4).unbind(0)


def synthetic_images(key, n: int, num_classes: int = 10, side: int = 28,
                     noise: float = 0.35, device=None):
    """The digits task: (x (n, side, side, 1) float32 in [0, 1], y (n,)
    int64) on ``device`` (default: the GPU)."""
    kp, ky, kn, ks = _draws(key, device)
    protos = _prototypes(kp, (num_classes, 7, 7), (side, side))
    y = rng.randint(ky, (n,), 0, num_classes)
    img = protos[y] + rng.normal(kn, (n, side, side)) * noise
    shifts = rng.randint(ks, (n, 2), -2, 3)
    x = torch.sigmoid(2.0 * _roll(img, shifts[:, 0], shifts[:, 1]))
    return x[..., None].to(torch.float32), y


def synthetic_rgb_images(key, n: int, num_classes: int = 10,
                         side: int = 32, channels: int = 3,
                         noise: float = 0.35, device=None):
    """The CIFAR-shaped task: (x (n, side, side, channels) in [0, 1], y
    (n,)).  Per-channel prototypes from a coarser 8x8 grid, so classes
    are separable by colour and spatial structure."""
    kp, ky, kn, ks = _draws(key, device)
    protos = _prototypes(kp, (num_classes, 8, 8, channels), (side, side))
    y = rng.randint(ky, (n,), 0, num_classes)
    img = protos[y] + rng.normal(kn, (n, side, side, channels)) * noise
    shifts = rng.randint(ks, (n, 2), -3, 4)
    x = torch.sigmoid(2.0 * _roll(img, shifts[:, 0], shifts[:, 1]))
    return x.to(torch.float32), y


def synthetic_audio(key, n: int, num_classes: int = 12, frames: int = 32,
                    mels: int = 40, noise: float = 0.3, device=None):
    """The speech-commands-shaped task: (x (n, frames, mels, 1), y (n,)).
    Each class is a smooth time-frequency track (a coarse 8x10 grid
    upsampled to frames x mels), jittered per sample and rolled along
    time only."""
    kp, ky, kn, ks = _draws(key, device)
    protos = _prototypes(kp, (num_classes, 8, 10), (frames, mels))
    y = rng.randint(ky, (n,), 0, num_classes)
    img = protos[y] + rng.normal(kn, (n, frames, mels)) * noise
    shifts = rng.randint(ks, (n,), -4, 5)
    x = torch.sigmoid(2.0 * _roll(img, shifts))
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
