"""Sweep grids: which hyperparameters batch, and how points are built.

A :class:`SweepGrid` is the cartesian product of value lists over named
axes, rooted at one base ``FederatedConfig`` and ``ChannelConfig`` (and
optionally one base :class:`~repro_torch.data.partition.PartitionSpec`),
as the reference's.  Four kinds of axis exist:

* **config axes** (:data:`FED_SWEEPABLE`, :data:`CH_SWEEPABLE`) — fields
  a group's step takes as per-point values (step sizes, conversion
  budgets, link budgets, codec parameters) or that the engine absorbs
  on the host before the rounds (seed budgets, sampled cohorts);
* **structural axes** (:data:`GROUP_SWEEPABLE`: ``protocol``, ``codec``,
  ``model``, ``task``) — the engine groups points by (protocol, codec
  family, cohort size, model, task) and builds one program a group: one
  captured local step (per architecture) and one captured conversion
  step;
* **partition axes** (:data:`PART_SWEEPABLE`: ``partition``, ``alpha``,
  ``n_local``) — which device partition a point trains on: each point
  carries a :class:`PartitionSpec`, each distinct one is built once.

Fields that would change a group's shapes beyond what the engine pads or
groups (population size, local SGD geometry, round count, the fading
window) stay static, taken from the base configs.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from ..channel import ChannelConfig
from ..channel.payload import CODECS, parse_codec
from ..core.protocols import FederatedConfig
from ..core.seed_prep import seed_fields_key
from ..data.partition import PARTITION_SCHEMES, PartitionSpec
from ..data.pipeline import parse_task
from ..models.registry import parse_model
from ..registry import canonical_protocol

#: Per-point config values of a group's step, or absorbed on the host
#: (sample_ratio / sample_seed: cohorts are drawn per point on the host
#: and fed to the rounds as gather indices).
FED_SWEEPABLE = frozenset({
    "eta", "beta", "eps", "lam", "n_seed", "n_inverse", "server_iters",
    "sample_bits", "seed", "quant_bits", "dp_sigma", "dp_clip",
    "dp_delta", "sample_ratio", "sample_seed",
})
#: Channel fields enter only through the host-computed link budget (the
#: per-slot success probability and the decode-slot counts), so any of
#: them can sweep except the draw-shaping t_max_slots / num_devices /
#: tau_s.
CH_SWEEPABLE = frozenset({
    "num_channels", "bandwidth_hz", "p_up_dbm", "p_dn_dbm", "distance_m",
    "pathloss_exp", "noise_dbm_hz", "theta",
})
#: Partition axes -> PartitionSpec fields.
PART_SWEEPABLE = frozenset({"partition", "alpha", "n_local"})
_PART_FIELD = {"partition": "scheme", "alpha": "alpha", "n_local": "n_local"}
#: Structural axes: one program per (protocol, codec family, cohort
#: size, model, task) group.  ``model`` values may be composite
#: ("cnn+mlp"): a mixed-architecture FD-family cohort per point.
GROUP_SWEEPABLE = frozenset({"protocol", "codec", "model", "task"})

ALL_SWEEPABLE = FED_SWEEPABLE | CH_SWEEPABLE | PART_SWEEPABLE | \
    GROUP_SWEEPABLE


@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """A validated config grid: ``points[g]`` is the (fc, ch) pair of grid
    point g, in C-order (last axis fastest) over ``axes``; ``parts[g]``
    is the point's :class:`PartitionSpec` (None for grids that take one
    pre-partitioned dataset)."""
    base_fc: FederatedConfig
    base_ch: ChannelConfig
    axes: tuple            # ((name, values), ...)
    points: tuple
    parts: tuple = ()      # per-point PartitionSpec | None
    base_part: Optional[PartitionSpec] = None

    @property
    def shape(self) -> tuple:
        return tuple(len(v) for _, v in self.axes)

    @property
    def size(self) -> int:
        return len(self.points)

    @property
    def partitioned(self) -> bool:
        """True iff every point names its own device partition (the
        runner then takes a flat sample pool, not (D, n_local) data)."""
        return bool(self.parts) and self.parts[0] is not None

    def labels(self) -> list:
        """Per-point {axis: value} dicts, aligned with ``points``."""
        names = [n for n, _ in self.axes]
        return [dict(zip(names, combo)) for combo in
                itertools.product(*(v for _, v in self.axes))]

    def point_name(self, g: int, label: Optional[dict] = None) -> str:
        lab = label if label is not None else self.labels()[g]
        return "_".join(f"{k}{v}" for k, v in lab.items()) or f"pt{g}"

    def seed_key(self, g: int) -> tuple:
        """The seed-determining identity of point ``g``: the config's seed
        fields and the partition spec it trains on."""
        return (seed_fields_key(self.points[g][0]),
                self.parts[g] if self.parts else None)

    def seed_groups(self) -> dict:
        """{seed_key: [point indices]}."""
        groups: dict = {}
        for g in range(self.size):
            groups.setdefault(self.seed_key(g), []).append(g)
        return groups

    def protocol_groups(self) -> dict:
        """{protocol: [point indices]} in point order."""
        groups: dict = {}
        for g, (fc, _) in enumerate(self.points):
            groups.setdefault(fc.protocol, []).append(g)
        return groups

    def program_groups(self) -> dict:
        """{(protocol, codec family, cohort size, model, task): [point
        indices]} in point order: the engine's unit of one program.  The
        codec's numeric parameters, the sample seed and every config
        axis stay per-point values inside a group."""
        groups: dict = {}
        for g, (fc, _) in enumerate(self.points):
            key = (fc.protocol, fc.codec_spec().name, fc.cohort_size(),
                   fc.model_key(), fc.task)
            groups.setdefault(key, []).append(g)
        return groups

    def task_groups(self) -> dict:
        """{task name: [point indices]}: one data pool and test set a
        task."""
        groups: dict = {}
        for g, (fc, _) in enumerate(self.points):
            groups.setdefault(fc.task, []).append(g)
        return groups

    @property
    def tasked(self) -> bool:
        """True iff the grid sweeps the ``task`` axis."""
        return any(n == "task" for n, _ in self.axes)


def _validate_axis(name: str, values: tuple):
    if name not in ALL_SWEEPABLE:
        fed_static = {f.name for f in dataclasses.fields(FederatedConfig)
                      } - FED_SWEEPABLE - GROUP_SWEEPABLE
        ch_static = {f.name for f in dataclasses.fields(ChannelConfig)
                     } - CH_SWEEPABLE
        kind = ("static (shape/control-flow) field"
                if name in fed_static | ch_static else "unknown field")
        raise ValueError(
            f"axis {name!r} is a {kind}; sweepable axes: "
            f"{sorted(FED_SWEEPABLE)} + {sorted(CH_SWEEPABLE)} + "
            f"{sorted(PART_SWEEPABLE)} + {sorted(GROUP_SWEEPABLE)}")
    if not values:
        raise ValueError(f"axis {name!r} has no values")
    checks = {"protocol": ("protocol", canonical_protocol),
              "codec": ("codec", parse_codec),
              "model": ("model spec", parse_model),
              "task": ("task", parse_task)}
    if name in checks:
        what, parse = checks[name]
        for v in values:
            try:
                parse(v)
            except ValueError as e:
                extra = f" (families: {CODECS})" if name == "codec" else ""
                raise ValueError(
                    f"{name} axis value {v!r} is not a registered "
                    f"{what}: {e}{extra}") from None
    if name == "partition":
        for v in values:
            if v not in PARTITION_SCHEMES:
                raise ValueError(
                    f"partition axis value {v!r} is not a registered "
                    f"partition scheme; one of {PARTITION_SCHEMES}")


def make_grid(base_fc: FederatedConfig,
              base_ch: Optional[ChannelConfig] = None,
              base_part: Optional[PartitionSpec] = None,
              **axes) -> SweepGrid:
    """Build a :class:`SweepGrid` from a base config pair and keyword
    axes, e.g. ``make_grid(fc, ch, n_seed=(10, 50), eta=(0.01, 0.02))``
    or ``make_grid(fc, ch, protocol=("fl", "mix2fld"),
    partition=("iid", "noniid"))``.

    Raises ValueError for unknown or static axis names, for empty value
    lists and for unregistered protocol, codec, partition, model or task
    values; the axis order (the grid's C-order) follows the keywords.
    Grids with partition or task axes (or an explicit ``base_part``)
    carry a :class:`PartitionSpec` per point, and their runner takes the
    flat sample pool instead of pre-partitioned (D, n_local) data."""
    base_ch = base_ch or ChannelConfig(num_devices=base_fc.num_devices)
    axes = {n: tuple(v) for n, v in axes.items()}
    for name, values in axes.items():
        _validate_axis(name, values)
    partitioned = base_part is not None or any(
        n in PART_SWEEPABLE or n == "task" for n in axes)
    base_part = base_part or (PartitionSpec() if partitioned else None)

    items = tuple(axes.items())
    points, parts = [], []
    for combo in itertools.product(*(v for _, v in items)):
        fc_kw, ch_kw, pt_kw = {}, {}, {}
        for (name, _), value in zip(items, combo):
            if name in CH_SWEEPABLE:
                ch_kw[name] = value
            elif name in PART_SWEEPABLE:
                pt_kw[_PART_FIELD[name]] = value
            else:   # FederatedConfig fields
                fc_kw[name] = value
        if "task" in fc_kw:
            # re-derive the task's class count and payload width per
            # point (an explicit sample_bits axis still wins)
            fc_kw["num_classes"] = None
            fc_kw.setdefault("sample_bits", None)
        if "model" in fc_kw:
            fc_kw["model_partition"] = None
        points.append((dataclasses.replace(base_fc, **fc_kw),
                       dataclasses.replace(base_ch, **ch_kw)))
        parts.append(dataclasses.replace(base_part, **pt_kw)
                     if partitioned else None)
    return SweepGrid(base_fc=base_fc, base_ch=base_ch, axes=items,
                     points=tuple(points), parts=tuple(parts),
                     base_part=base_part)
