"""The task registry, digits only: a :class:`TaskSpec` names one workload
(input shape, class count, per-sample uplink payload width).  ``cifar``
and ``speech`` wait for a later slice."""
from __future__ import annotations

import dataclasses
import math

TASK_ALIASES = {"mnist": "digits"}


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


DIGITS = TaskSpec("digits", (28, 28, 1), 10, 8)


def parse_task(name: str) -> TaskSpec:
    """Resolve a task name; only digits (alias mnist) is ported."""
    if TASK_ALIASES.get(name, name) == "digits":
        return DIGITS
    if name in ("cifar", "cifar10", "speech", "speech_commands"):
        raise NotImplementedError(
            f"task {name!r} is not ported yet (ROADMAP A10)")
    raise ValueError(f"unknown task {name!r}; one of ('digits',) "
                     f"(aliases: {TASK_ALIASES})")
