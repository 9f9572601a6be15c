"""Placements of the federated round loop's operands on the meshes of
``launch/mesh.py``, as DTensor placements (the reference's
PartitionSpecs).

A placement tuple has one entry a mesh dim: ``Shard(i)`` splits tensor
dim ``i`` over that mesh dim, ``Replicate()`` keeps it whole.  The
reference's ``P("data")`` on the ("data",) mesh is ``(Shard(0),)``; its
``P("grid", "data")`` on the ("grid", "data") mesh is ``(Shard(0),
Shard(1))``; ``P()`` is a ``Replicate()`` on every dim.

No path of the port reads these yet: the federated path splits its
device axis by hand (``core/protocols.py`` ``GridShards``) and keeps its
replicas equal through deterministic computation.  They state the
layout contract the sharded path follows, which the tests hold to the
reference's PartitionSpecs; the dry run will read them with the LM
rules.

The LM rules of the reference (``param_pspecs``, ``cache_pspecs``,
``batch_pspecs``, ``logical_constraints``, ``activation_constrainer``)
are read only by the dry run and come with ``launch/dryrun.py``.
"""
from __future__ import annotations

from torch.distributed.tensor import Replicate, Shard


def federated_pspecs() -> dict:
    """Placements on the 1-D ("data",) mesh (``make_device_mesh``):
    ``device`` shards the leading device axis of every per-device operand
    (stacked params, local data, per-round keys, per-device G_out
    tables); ``replicated`` covers scalars and the aggregated tables the
    all-reduces return on every rank."""
    return {"device": (Shard(0),), "replicated": (Replicate(),)}


def federated_grid_pspecs() -> dict:
    """Placements on the 2-D ("grid", "data") mesh (``make_grid_mesh``):

    * ``gdev`` — (G, D, ...) operands: the grid axis over "grid", the
      device axis over "data";
    * ``gcfg`` — (G, ...) per-point values: the grid axis only, whole on
      each "data" shard;
    * ``data`` — (D, ...) operands shared by the grid points: the device
      axis only, whole over "grid";
    * ``replicated`` — true scalars.

    The device-axis sums reduce over "data" only: each grid shard's sum
    spans its own points' device rows."""
    return {"gdev": (Shard(0), Shard(1)),
            "gcfg": (Shard(0), Replicate()),
            "data": (Replicate(), Shard(0)),
            "replicated": (Replicate(), Replicate())}
