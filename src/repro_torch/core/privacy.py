"""Privacy metrics and mechanisms (Sec. IV Tables II/III; DP uplink).

* **Sample privacy** (the paper's metric): :func:`sample_privacy` scores
  an uploaded (mixed / inversely mixed) sample by the log of its minimum
  L2 distance to any raw constituent.  Higher = more private.
* **Differential privacy** (the ``dp_gaussian`` link codec):
  :func:`gaussian_mechanism` clips a payload to a fixed L2 sensitivity
  and adds Gaussian noise before it crosses the uplink
  (:func:`gaussian_mechanism_tree`: a tree under one global clip), and
  :class:`GaussianAccountant` tracks the (epsilon, delta) spend: one
  release with noise multiplier sigma is (eps0, delta)-DP for
  ``eps0 = sqrt(2 ln(1.25/delta)) / sigma``, composed linearly.

The noise is drawn from :mod:`repro_torch.rng` in the reference's
order: per device a key, per parameter leaf ``fold_in(key, i)`` in the
reference's leaf order and shape (see ``channel/payload.py``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import rng
from ..checkpoint import _flatten_with_paths, _unflatten


def sample_privacy(uploaded, raws):
    """uploaded: (N, ...) uploaded samples; raws: (N, R, ...) — the R raw
    samples each uploaded sample is compared against.  Returns (N,)
    log-min-distances."""
    n = uploaded.shape[0]
    u = uploaded.reshape(n, 1, -1)
    r = raws.reshape(n, raws.shape[1], -1)
    d = torch.linalg.vector_norm(u - r, dim=-1)            # (N, R)
    return torch.log(d.amin(-1).clamp_min(1e-12))


def mean_privacy(uploaded, raws) -> float:
    return float(sample_privacy(uploaded, raws).mean())


def clip_scale(sq_norm, clip):
    """min(1, clip / max(||x||, 1e-12)) from the squared norm."""
    nrm = torch.sqrt(sq_norm)
    return torch.clamp(clip / nrm.clamp_min(1e-12), max=1.0)


def clip_by_norm(x, clip):
    """Scale ``x`` so its global L2 norm is at most ``clip``."""
    return x * clip_scale((x * x).sum(), clip)


def gaussian_mechanism(x, key, noise, clip):
    """Clip ``x`` to L2 norm ``clip`` and add N(0, noise^2) noise per
    element, ``noise`` the standard deviation ``sigma * clip``: one
    (eps0, delta)-DP release.  ``key`` (..., 2) may hold one key per
    leading row of ``x`` (the reference's vmap over devices); each row
    is then clipped on its own, and ``noise`` and ``clip`` may be
    tensors of one value a row."""
    batch = key.shape[:-1]
    shape = tuple(x.shape[len(batch):])
    noise = noise * rng.normal(key, shape)
    dims = tuple(range(len(batch), x.dim()))
    sq = (x * x).sum(dims, keepdim=True) if dims else x * x
    return x * clip_scale(sq, clip) + noise


def gaussian_mechanism_tree(tree, key, sigma, clip):
    """:func:`gaussian_mechanism` for a tree payload (a model update, a
    dict tree of float32 tensors): the clip bounds the *global* L2 norm
    across the leaves, and leaf i (in the reference's order: dict keys
    sorted, depth first, as a checkpoint flattens a tree) gets
    N(0, (sigma*clip)^2) noise in its own shape from ``fold_in(key, i)``.
    Returns a tree of the same structure."""
    _, leaves = _flatten_with_paths(tree)
    nrm = torch.sqrt(sum((x * x).sum() for x in leaves))
    scale = torch.clamp(clip / nrm.clamp_min(1e-12), max=1.0)
    return _unflatten(tree, [
        x * scale + sigma * clip
        * rng.normal(rng.fold_in(key, i), tuple(x.shape))
        for i, x in enumerate(leaves)])


def gaussian_epsilon(sigma: float, delta: float, rounds: int = 1) -> float:
    """Epsilon of ``rounds`` Gaussian releases with noise multiplier
    ``sigma`` under basic composition."""
    if sigma <= 0:
        raise ValueError(f"dp_gaussian needs sigma > 0, got {sigma}")
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    return rounds * math.sqrt(2.0 * math.log(1.25 / delta)) / sigma


@dataclasses.dataclass
class GaussianAccountant:
    """Per-round (epsilon, delta) ledger of the ``dp_gaussian`` codec.
    ``step(cohort=...)`` once per round that released a noised payload;
    with the round's cohort it also counts each device's own rounds
    (:attr:`device_counts`), so :meth:`epsilon_device_max` composes over
    the busiest device's rounds only."""
    sigma: float
    delta: float = 1e-5
    rounds: int = 0
    sample_ratio: float = 1.0
    device_counts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))

    def __post_init__(self):
        gaussian_epsilon(self.sigma, self.delta, 1)
        self.device_counts = np.asarray(self.device_counts, np.int64)

    @property
    def epsilon_per_round(self) -> float:
        return gaussian_epsilon(self.sigma, self.delta, 1)

    @property
    def device_rounds(self) -> dict:
        """``{device: rounds}`` of the nonzero participation counts (the
        ledger format of older checkpoints)."""
        (nz,) = np.nonzero(self.device_counts)
        return {int(d): int(self.device_counts[d]) for d in nz}

    @device_rounds.setter
    def device_rounds(self, mapping: dict):
        counts = np.zeros(max(map(int, mapping), default=-1) + 1, np.int64)
        for d, c in mapping.items():
            counts[int(d)] = int(c)
        self.device_counts = counts

    def step(self, n: int = 1, cohort=None) -> "GaussianAccountant":
        """Record ``n`` rounds of release; ``cohort`` is the rounds'
        active-device indices (None: every device charged)."""
        self.rounds += n
        if cohort is not None:
            idx = np.asarray(cohort, np.int64).ravel()
            if idx.size:
                hi = int(idx.max()) + 1
                if hi > self.device_counts.size:
                    self.device_counts = np.concatenate(
                        [self.device_counts,
                         np.zeros(hi - self.device_counts.size, np.int64)])
                np.add.at(self.device_counts, idx, n)
        return self

    def device_rounds_max(self) -> int:
        """Rounds of the most-participating device (``rounds`` when no
        cohort was recorded)."""
        if not self.device_counts.size:
            return self.rounds
        return int(self.device_counts.max())

    def epsilon(self, rounds: int | None = None) -> float:
        return gaussian_epsilon(self.sigma, self.delta,
                                self.rounds if rounds is None else rounds)

    def epsilon_device_max(self) -> float:
        """Worst per-device epsilon over its own rounds."""
        r = self.device_rounds_max()
        return self.epsilon(r) if r else 0.0

    def ledger(self) -> dict:
        """JSON-ready accountant state for histories."""
        return {"sigma": self.sigma, "delta": self.delta,
                "rounds": self.rounds,
                "epsilon_per_round": self.epsilon_per_round,
                "epsilon": self.epsilon() if self.rounds else 0.0,
                "sample_ratio": self.sample_ratio,
                "participating_devices": (
                    int((self.device_counts > 0).sum())
                    if self.device_counts.size else None),
                "device_rounds_max": self.device_rounds_max(),
                "epsilon_device_max": self.epsilon_device_max()}
