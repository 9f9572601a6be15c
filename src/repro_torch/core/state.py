"""The round loop's state: one frozen :class:`RoundState`.

Fields as in the reference (the checkpoint manifest's keys): ``round``,
``key`` (the run key; every per-round draw derives from
``fold_in(key, round)``), the global and device-stacked parameters, the
global and per-device G_out tables, the previous flat global state for
the convergence check, ``converged_round``, the round-1 ``seeds`` and
the cumulative time.  The grid layout of the sweep engine waits for that
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class RoundState:
    round: int = 0
    key: Any = None
    g_params: Any = None
    dev_params: Any = None
    gout: Any = None
    dev_gout: Any = None
    prev: Any = None
    converged_round: Any = None
    seeds: Any = None
    cum_time_s: float = 0.0
