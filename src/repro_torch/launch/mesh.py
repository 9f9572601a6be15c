"""Meshes of ranks for the federated device axis, the card's constants,
and the collectives of the sharded round loop.

The reference lays the federated device axis along a jax mesh — ``("data",)``
for the round loop, ``("grid", "data")`` for a sweep — and reduces
with ``psum`` inside ``shard_map``.  The port runs one process a rank
(``torch.distributed``): a mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the first ranks
of the default process group, and its backend follows the device (NCCL
for CUDA, gloo for the CPU).  When no group is running,
:func:`ensure_process_group` starts one: a launcher's world when the
environment names one (``torchrun --nproc-per-node N`` sets
``WORLD_SIZE`` > 1, ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` and
starts no group; the ranks join through ``env://``), else a one-rank
group, so ``shard_devices=True`` in a plain process runs the sharded
path on one shard, as the reference does on one chip.  The mesh takes
the first ranks whose count divides the population.

Ranks beyond the mesh hold no rows: they add zeros to every sum
(``x + 0.0`` is exact) and a block of zeros to every gather, so a run on
W ranks equals a run on the mesh's S ranks — the counterpart of jax
building the mesh on the first S chips.  For the same reason every
collective spans the default group: a sum that reduces over ``"data"``
on a 2-D mesh places each grid shard's partial sums at its own points
and zeros elsewhere, so no point's sum ever adds another grid shard's
values.

Collectives go through :func:`all_reduce_sum` and
:func:`all_gather_rows`, and only through them: each records its calls
and bytes (the result's, per rank, as the roofline's HLO parser counts
them) on :data:`COLLECTIVES`, which ``roofline.analysis.
collective_bytes_from_log`` reads.  The replicas agree through
deterministic computation, so the federated path broadcasts nothing.

The production meshes of the LM sharding rules (``launch/sharding.py``)
are :func:`make_production_mesh` — (16, 16) ``("data", "model")``, or
(2, 16, 16) ``("pod", "data", "model")`` across two pods, whose "pod"
dim is the Mix2FLD device axis: the cross-pod link is the scarce
uplink — and :func:`make_host_mesh`, (1, 1) ``("data", "model")`` on one
card.  The dry run (``launch/dryrun.py``) builds the production meshes
in a fake world of 512 ranks on the CPU.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

# NVIDIA H100 80GB HBM3 (SXM, 700 W) datasheet figures, per card; the
# roofline's terms (they replace the reference's TPU v5e constants)
PEAK_FLOPS_BF16 = 989e12   # dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12     # float32 outside the tensor cores
HBM_BW = 3.35e12           # bytes/s of HBM3
NVLINK_BW = 450e9          # bytes/s a direction (NVLink 4, 18 links); the
#                            card has no ICI: this replaces ICI_BW


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def world_size() -> int:
    """Ranks of the default process group (1 when none is started)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def ensure_process_group(device=None) -> None:
    """Start the default group on the device's backend unless one is
    running (a caller's): the launcher's world through ``env://`` when
    the environment's ``WORLD_SIZE`` is above 1, else a one-rank
    group."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(_backend(dev), init_method="env://")
        return
    dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(shape: tuple, axis_names: tuple, device=None):
    """A DeviceMesh of ``shape`` over the first ``prod(shape)`` ranks of
    the default group, dims named ``axis_names`` (the counterpart of
    ``jax.make_mesh``)."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    ensure_process_group(dev)
    n = 1
    for s in shape:
        n *= int(s)
    if n > world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks but the "
                         f"process group has {world_size()}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device=None):
    """The one-rank mesh of the same dim names, (1, 1) ``("data",
    "model")``."""
    return make_mesh((1, 1), ("data", "model"), device)


def _largest_divisor(n: int, limit: int) -> int:
    """Largest divisor of ``n`` that is <= ``limit`` (>= 1)."""
    return max(d for d in range(1, max(1, min(n, limit)) + 1)
               if n % d == 0)


def make_device_mesh(num_devices: int, shards: Optional[int] = None,
                     device=None):
    """1-D ("data",) mesh for the federated device axis of the round loop
    (``FederatedConfig.shard_devices``).  Blocks are equal-sized, so the
    shard count defaults to the largest divisor of the population that
    fits the world size; one rank gives a one-shard mesh, on which the
    sharded path equals the vmapped path bit for bit."""
    ensure_process_group(resolve_device(device))
    avail = world_size()
    if shards is None:
        shards = _largest_divisor(num_devices, avail)
    if num_devices % shards:
        raise ValueError(f"device population {num_devices} not divisible "
                         f"by {shards} mesh shards")
    return make_mesh((shards,), ("data",), device)


def grid_mesh_shape(grid_size: int, num_devices: int,
                    shape: Optional[tuple] = None,
                    avail: Optional[int] = None) -> tuple[int, int]:
    """The ``(grid_shards, device_shards)`` shape of a 2-D mesh, without
    building it.  Auto-shaping spends ranks on the grid axis first (grid
    points share no reduction; device shards pay an all-reduce per
    aggregation).  Both entries must divide their axis; an explicit
    ``shape`` that does not is an error.  ``avail`` defaults to the
    world size of the default group."""
    avail = world_size() if avail is None else avail
    if shape is not None:
        gs, ds = int(shape[0]), int(shape[1])
        if gs < 1 or ds < 1:
            raise ValueError(f"mesh shape entries must be >= 1, "
                             f"got {shape}")
        if grid_size % gs:
            raise ValueError(f"grid size {grid_size} not divisible by "
                             f"{gs} grid shards")
        if num_devices % ds:
            raise ValueError(f"device population {num_devices} not "
                             f"divisible by {ds} device shards")
        if gs * ds > avail:
            raise ValueError(f"mesh shape {gs}x{ds} needs {gs * ds} "
                             f"chips but only {avail} are available")
        return gs, ds
    gs = _largest_divisor(grid_size, avail)
    ds = _largest_divisor(num_devices, avail // gs)
    return gs, ds


def make_grid_mesh(grid_size: int, num_devices: int,
                   shape: Optional[tuple] = None, device=None):
    """2-D ("grid", "data") mesh for sweeps: grid points along "grid",
    each point's device axis along "data".  One rank gives (1, 1), on
    which the sharded program equals the vmapped one."""
    ensure_process_group(resolve_device(device))
    gs, ds = grid_mesh_shape(grid_size, num_devices, shape)
    return make_mesh((gs, ds), ("grid", "data"), device)


def data_axes(mesh) -> tuple:
    """Axes that shard the batch: ("pod","data") when pods exist."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def mesh_coordinate(mesh) -> Optional[tuple]:
    """This rank's coordinate on ``mesh``, None for a rank beyond it."""
    c = mesh.get_coordinate()
    return None if c is None else tuple(int(i) for i in c)


# ---------------------------------------------------------------------------
# Collectives of the federated path, each recorded on COLLECTIVES
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollectiveLog:
    """Calls of the collectives: ``records`` holds ``(kind, bytes,
    ranks)`` a call, ``kind`` the HLO name ("all-reduce" or
    "all-gather"), ``bytes`` the result's size on one rank, ``ranks``
    the ranks of the group."""
    records: list = dataclasses.field(default_factory=list)

    def reset(self) -> None:
        self.records.clear()

    def record(self, kind: str, nbytes: int) -> None:
        self.records.append((kind, int(nbytes), tuple(range(world_size()))))

    def calls(self, kind: Optional[str] = None) -> int:
        return sum(1 for k, _, _ in self.records if kind in (None, k))

    def bytes(self, kind: Optional[str] = None) -> int:
        return sum(b for k, b, _ in self.records if kind in (None, k))


COLLECTIVES = CollectiveLog()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every rank, in place of a contiguous copy
    (returned)."""
    t = t.contiguous()
    COLLECTIVES.record("all-reduce", _nbytes(t))
    ensure_process_group(t.device)
    dist.all_reduce(t)
    return t


def all_gather_rows(block: torch.Tensor) -> torch.Tensor:
    """Every rank's ``block`` (the same shape on each), stacked along a
    new leading rank axis: ``(world, *block.shape)``.  The list form of
    ``all_gather`` (gloo has no tensor form on every device)."""
    block = block.contiguous()
    n = world_size()
    COLLECTIVES.record("all-gather", _nbytes(block) * n)
    ensure_process_group(block.device)
    out = [torch.empty_like(block) for _ in range(n)]
    dist.all_gather(out, block)
    return torch.stack(out)

