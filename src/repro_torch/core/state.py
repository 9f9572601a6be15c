"""The round loop's state: one frozen :class:`RoundState`.

Fields as in the reference (the checkpoint manifest's keys): ``round``,
``key`` (the run key; every per-round draw derives from
``fold_in(key, round)``), the global and device-stacked parameters, the
global and per-device G_out tables, the previous flat global state for
the convergence check, ``converged_round``, the round-1 ``seeds`` and
the cumulative time.  In the sweep engine's grid layout
(``core/protocols.py`` :class:`GridRoundStep`) the tensors carry a
leading axis of the group's G points and the loop's host fields
(``round``, ``key``, ``seeds``, ``cum_time_s``) stay None.
"""
from __future__ import annotations

import dataclasses
from typing import Any

_FIELDS = ("round", "key", "g_params", "dev_params", "gout", "dev_gout",
           "prev", "converged_round", "seeds", "cum_time_s")
#: the grid carry's historical key for ``converged_round``
_ALIASES = {"converged": "converged_round"}


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

    @classmethod
    def from_mapping(cls, m: Any) -> "RoundState":
        """A state dict with the field names (``converged`` aliases
        ``converged_round``) as a RoundState; a RoundState passes
        through."""
        if isinstance(m, cls):
            return m
        kw = {_ALIASES.get(k, k): v for k, v in dict(m).items()}
        unknown = set(kw) - set(_FIELDS)
        if unknown:
            raise ValueError(f"unknown RoundState field(s) "
                             f"{sorted(unknown)}; fields: {_FIELDS}")
        return cls(**kw)

    def replace(self, **kw) -> "RoundState":
        """A copy with the given fields replaced."""
        return dataclasses.replace(
            self, **{_ALIASES.get(k, k): v for k, v in kw.items()})
