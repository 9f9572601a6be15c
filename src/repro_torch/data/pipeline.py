"""The task registry: a :class:`TaskSpec` names one workload (input
shape, class count, per-sample uplink payload width) and materializes
it.  The tasks are synthetic stand-ins with the real dataset's geometry:
28x28x1 digits @ 8 bit, 32x32x3 CIFAR-shaped images @ 8 bit and a
speech-commands-shaped 32x40 log-mel gram @ 16 bit.  Name resolution
lives in ``registry.canonical_task``.  :func:`device_batches` and
:func:`global_batches` draw batch indices as the reference does."""
from __future__ import annotations

import dataclasses
import math

from .. import rng
from ..registry import TASKS, canonical_task
from .synthetic import synthetic_audio, synthetic_images, synthetic_rgb_images


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One workload.  ``sample_bits`` is the uplink payload of ONE raw
    (or mixed) sample, ``bits_per_feature * prod(input_shape)`` — the
    paper's b_s = 8 bit x 28 x 28 for digits."""
    name: str
    input_shape: tuple
    num_classes: int
    bits_per_feature: int

    @property
    def sample_bits(self) -> int:
        return self.bits_per_feature * math.prod(self.input_shape)

    def data(self, key, n: int, num_classes: int | None = None,
             device=None):
        """(x (n, *input_shape), y (n,)) from ``key`` on ``device``
        (default: the GPU); ``num_classes`` overrides the task's."""
        c = self.num_classes if num_classes is None else num_classes
        if self.name == "digits":
            return synthetic_images(key, n, num_classes=c,
                                    side=self.input_shape[0], device=device)
        if self.name == "cifar":
            return synthetic_rgb_images(key, n, num_classes=c,
                                        side=self.input_shape[0],
                                        channels=self.input_shape[2],
                                        device=device)
        return synthetic_audio(key, n, num_classes=c,
                               frames=self.input_shape[0],
                               mels=self.input_shape[1], device=device)


_TASK_SPECS = {
    "digits": TaskSpec("digits", (28, 28, 1), 10, 8),
    "cifar": TaskSpec("cifar", (32, 32, 3), 10, 8),
    "speech": TaskSpec("speech", (32, 40, 1), 12, 16),
}
assert set(_TASK_SPECS) == set(TASKS)


def parse_task(name: str) -> TaskSpec:
    """Resolve a task name (canonical or alias) to its :class:`TaskSpec`;
    unknown names raise ``canonical_task``'s shared ValueError."""
    return _TASK_SPECS[canonical_task(name)]


def device_batches(key, n_local: int, iters: int, batch_size: int):
    """(iters, batch_size) random sample indices into a device's dataset,
    on the key's device."""
    return rng.randint(key, (iters, batch_size), 0, n_local)


def global_batches(key, x, y, batch_size: int, steps: int):
    """Host-side iterator of random batches of a flat dataset (tensors):
    step s draws its indices from ``fold_in(key, s)``."""
    n = x.shape[0]
    for s in range(steps):
        idx = rng.randint(rng.fold_in(key, s), (batch_size,), 0, n)
        idx = idx.to(x.device)
        yield x[idx], y[idx]
