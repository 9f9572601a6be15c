"""Per-round client sampling: stateless seeded cohort draws.

A round trains the ``cohort_size`` devices with the smallest uniforms of
the round's participation stream, ``np.random.default_rng([fed_seed,
sampler_seed, round, mechanism])`` on the host, as in the reference, so
cohorts are bit-equal.  The cohort is a pure function of the seeds and
the round: a resumed run re-draws the same cohorts.  Churn
(:class:`ChurnConfig`) thresholds uniforms of its own stream
(:data:`MECH_CHURN`), so the service's churned cohorts are a pure
function of the seeds and the round too.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

MECH_SAMPLE = 0   #: fixed-size client sampling (SamplerConfig)
MECH_CHURN = 1    #: Bernoulli device churn (ChurnConfig)


def participation_rng(fed_seed: int, sampler_seed: int, round_: int,
                      mechanism: int = MECH_SAMPLE) -> np.random.Generator:
    """The stateless per-round participation stream of one mechanism."""
    return np.random.default_rng([int(fed_seed), int(sampler_seed),
                                  int(round_), int(mechanism)])


def participation_uniforms(fed_seed: int, sampler_seed: int, round_: int,
                           pool_size: int, mechanism: int = MECH_SAMPLE):
    """One uniform per pool device from the round's stream, and the
    generator, advanced past them (churn's top-up draws from it)."""
    gen = participation_rng(fed_seed, sampler_seed, round_, mechanism)
    return gen.random(pool_size), gen


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Seeded, stateless fixed-size client sampling: each round trains
    ``cohort_size = ceil(q * pool)`` devices (clamped to ``[min_active,
    pool]``); ``sample_ratio = 1`` trains the whole pool, in order."""
    sample_ratio: float = 1.0
    min_active: int = 1
    seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.sample_ratio <= 1.0:
            raise ValueError(f"sample_ratio must be in (0, 1], "
                             f"got {self.sample_ratio}")
        if self.min_active < 1:
            raise ValueError("min_active must be >= 1: a round needs at "
                             "least one training device")

    def cohort_size(self, pool_size: int) -> int:
        """ceil(q * pool), at least ``min_active``, at most the pool (the
        1e-9 slack makes 0.3 * 10 mean 3 devices, not 4)."""
        want = math.ceil(self.sample_ratio * pool_size - 1e-9)
        return min(pool_size, max(want, min(self.min_active, pool_size)))

    def cohort(self, fed_seed: int, round_: int,
               pool_size: int) -> np.ndarray:
        """Sorted device indices of round ``round_``: the ``cohort_size``
        smallest uniforms (the stream is drawn even at full size)."""
        size = self.cohort_size(pool_size)
        u, _ = participation_uniforms(fed_seed, self.seed, round_,
                                      pool_size)
        if size >= pool_size:
            return np.arange(pool_size)
        return np.sort(np.argpartition(u, size)[:size])

    def participation_counts(self, fed_seed: int, rounds: int,
                             pool_size: int) -> np.ndarray:
        """(pool_size,) rounds each device trained in over ``1..rounds``:
        what DP composition counts (``core/privacy.py``)."""
        counts = np.zeros(pool_size, np.int64)
        for p in range(1, rounds + 1):
            counts[self.cohort(fed_seed, p, pool_size)] += 1
        return counts


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Seeded device churn: each round every pool device is active with
    probability ``p_active``; a draw with fewer than ``min_active`` is
    topped up from the same generator.  ``p_active = 1`` disables churn
    (the stream is still drawn)."""
    p_active: float = 1.0
    min_active: int = 1
    seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.p_active <= 1.0:
            raise ValueError(f"p_active must be in (0, 1], "
                             f"got {self.p_active}")
        if self.min_active < 1:
            raise ValueError("min_active must be >= 1: a round needs at "
                             "least one training device")

    def active_devices(self, fed_seed: int, round_: int,
                       pool_size: int) -> np.ndarray:
        """Sorted active-device indices of round ``round_``: the devices
        whose uniform of the round's churn stream is below ``p_active``,
        topped up to ``min_active`` by a choice among the others from the
        same generator.  The stream is consumed even at ``p_active = 1``,
        so nudging ``p_active`` across 1 shifts no other draw."""
        u, gen = participation_uniforms(fed_seed, self.seed, round_,
                                        pool_size, mechanism=MECH_CHURN)
        mask = u < self.p_active
        idx = np.flatnonzero(mask)
        want = min(self.min_active, pool_size)
        if len(idx) < want:
            extra = gen.choice(np.flatnonzero(~mask), size=want - len(idx),
                               replace=False)
            idx = np.concatenate([idx, extra])
        return np.sort(idx)
