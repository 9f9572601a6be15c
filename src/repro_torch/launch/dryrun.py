"""The dry run: every (architecture x input shape) step on the production
meshes, without a card and without allocating a weight, with its
per-rank bytes, collectives and roofline terms.

The reference lowers and compiles each step for 256 or 512 TPU chips and
reads XLA's buffer assignment and HLO.  The port runs the step once in a
fake world of 512 ranks on the CPU (``torch.distributed``'s "fake"
backend: every collective returns at once), on DTensors whose local
blocks lie on the meta device, placed by the sharding rules of
``launch/sharding.py``, with :func:`~repro_torch.launch.sharding.
sharding_hook` installed in ``models/shardhooks.py``.  The step is the
port's own (``launch/steps.py``); rank 0's view of it gives:

* the collectives: every functional collective DTensor issues, with the
  bytes of its result on one rank and the ranks of its group
  (:class:`CollectiveRecorder`), summed by ``roofline.analysis.
  collective_bytes_from_log``, cross-pod bytes included;
* the argument and output bytes of one rank, exact from the local
  blocks' shapes;
* ``memtracker_peak_bytes``: the peak of the bytes the step holds on rank
  0 (its arguments and everything it allocates), as
  ``torch.distributed._tools.mem_tracker.MemTracker`` counts the meta
  tensors' storages of the ops on the local blocks (not the fake
  tensors of DTensor's own propagation, which torch 2.11's MemTracker
  counts: :func:`_mem_tracker`).  A kernel on meta allocates only its
  output, as it does on the card (``kernels/runtime.py::shapes_only``);
  a prefill makes each rank's blocks of its cache alone
  (:func:`placed_zeros`).

Gaps of DTensor's strategies (a view of a sharded dim that DTensor
refuses, as 14 heads of 64 over 16 ranks; a masked partial sum; ops
whose strategies torch 2.11 or 2.13 fails, or which they would hold
whole on a rank) are bridged by redistributions or each rank's block,
placed as the rules place the tensor, and counted under ``reshards``
(:class:`ShardingGaps` lists each and the release that needs it).  An
op with no strategy at all fails the step, and its record is an
``error`` with the exception.  On torch 2.11 and 2.13 alike every
(arch x shape) of ``--all`` and ``--all --multi-pod`` is ``ok`` or
``skipped``.

Usage (CPU, no GPU needed; records under ``build/dryrun/``, or
``--out``):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --sync-steps

The command starts the fake world in its own process; a process that
already runs a process group cannot take it (:func:`start_fake_world`).
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from collections import Counter
from functools import partial
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import INPUT_SHAPES, get_config, input_specs, list_archs
from ..kernels.runtime import contiguous_strides
from ..models import kvcache
from ..models.shardhooks import set_activation_sharding
from ..models.transformer import init_params, tree_map
from ..roofline.analysis import (analytic_flops,  # noqa: F401
                                 collective_bytes_from_hlo,
                                 collective_bytes_from_log, dominant_term,
                                 roofline_terms)
from .. import rng
from . import sharding as shp
from .mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, make_host_mesh,
                   make_production_mesh)
from .steps import (make_decode_step, make_fd_sync_step, make_fl_sync_step,
                    make_prefill_step, make_train_step)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
FAKE_WORLD = 512   # the 2 x 16 x 16 mesh; the 16 x 16 takes its first 256
# the meshes' device type: their local blocks lie on the meta device.
# DTensor's backward strategies on a "cuda" mesh need a CUDA build, so the
# meshes are CPU meshes, on which DTensor turns a shard-to-shard
# all-to-all into an all-gather and a local chunk: those bytes are the
# all-gather's, more than NCCL's all-to-all moves
MESH_DEVICE = "cpu"


def start_fake_world(world: int = FAKE_WORLD) -> None:
    """Start a fake process group of ``world`` ranks (this process is
    rank 0), unless one of at least that size is running."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() >= world:
            return
        raise RuntimeError("the dry run takes a process of its own: this "
                           "one runs a process group already")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


# ---------------------------------------------------------------------------
# Counts
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def param_specs(cfg):
    """The parameter tree on the meta device: shapes and dtypes,
    nothing drawn or allocated."""
    return init_params(cfg, rng.PRNGKey(0, device="meta"), device="meta")


def count_from_specs(tree) -> int:
    return sum(math.prod(t.shape) for t in _leaves(tree))


def active_count_from_specs(cfg, tree) -> int:
    total = count_from_specs(tree)
    if not cfg.is_moe:
        return total
    moe = tree["blocks"]["moe"]
    routed = sum(math.prod(moe[w].shape) for w in ("w1", "w2", "w3"))
    return int(total - routed + routed * cfg.top_k / cfg.num_experts)


def model_flops(cfg, p_tree, shape_name: str) -> float:
    """6·N_active·tokens for training, 2·N_active·tokens for inference."""
    n = active_count_from_specs(cfg, p_tree)
    s = INPUT_SHAPES[shape_name]
    tokens = s.global_batch * (s.seq_len if s.kind != "decode" else 1)
    mult = 6 if s.kind == "train" else 2
    return float(mult) * n * tokens


# ---------------------------------------------------------------------------
# Placing trees and recording the step
# ---------------------------------------------------------------------------

def place(mesh, tree, spec_tree):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` placed by its
    spec: every rank takes its own block of its own copy, a view where
    the block is contiguous (no collective, no copy of a whole tensor).
    Non-tensor leaves (a cache's ``pos``) stay as they are."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    if isinstance(tree, dict):
        return {k: place(mesh, v, spec_tree[k]) for k, v in tree.items()}
    if not torch.is_tensor(tree):
        return tree
    placements = shp.to_placements(mesh, spec_tree, tree.ndim)
    shape, offset = compute_local_shape_and_global_offset(
        tree.shape, mesh, placements)
    block = tree[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return DTensor.from_local(block.contiguous(), mesh, placements,
                              run_check=False, shape=tree.shape,
                              stride=tree.stride())


def placed_zeros(mesh, c_specs):
    """``init_cache(batch, seq_len, device)`` for a prefill on ``mesh``:
    each leaf of ``kvcache.cache_shapes`` zeros of this rank's block,
    placed by its spec in ``c_specs`` (``cache_pspecs``).  No rank makes
    the whole cache first (the values are those of ``place`` of the
    whole zeros)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def zeros(shape, dtype, spec, device):
        placements = shp.to_placements(mesh, spec, len(shape))
        local, _ = compute_local_shape_and_global_offset(shape, mesh,
                                                         placements)
        return DTensor.from_local(
            torch.zeros(local, dtype=dtype, device=device), mesh, placements,
            run_check=False, shape=torch.Size(shape),
            stride=contiguous_strides(shape))

    def init_cache(cfg, batch: int, seq_len: int, device=None):
        return {group: 0 if group == "pos" else
                {k: zeros(s, d, c_specs[group][k], device)
                 for k, (s, d) in leaves.items()}
                for group, leaves in kvcache.cache_shapes(
                    cfg, batch, seq_len).items()}

    return init_cache


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in _leaves(tree):
        if torch.is_tensor(t):
            loc = t.to_local() if isinstance(t, DTensor) else t
            total += loc.numel() * loc.element_size()
    return total


_KINDS = {"all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
          "all_to_all_single": "all-to-all", "broadcast": "broadcast",
          "broadcast_": "broadcast", "shard_dim_alltoall": "all-to-all"}


class CollectiveRecorder(TorchDispatchMode):
    """Records every functional collective dispatched under it as
    ``(kind, bytes of the result on this rank, ranks of the group)``,
    the records ``collective_bytes_from_log`` takes."""

    def __init__(self):
        super().__init__()
        self.records: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor first: its collectives come back
        out = func(*args, **(kwargs or {}))
        ns, _, name = func._schema.name.partition("::")
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor") \
                and name in _KINDS:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            group = args[-1] if isinstance(args[-1], str) else \
                kwargs["group_name"]
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(group))
            res = out[0] if isinstance(out, (list, tuple)) else out
            self.records.append((_KINDS[name],
                                 res.numel() * res.element_size(),
                                 tuple(ranks)))
        return out


def _narrows(x, kwargs) -> bool:
    """A ``_to_copy`` of ``x`` to a floating dtype of fewer bits."""
    dt = kwargs.get("dtype")
    return (dt is not None and dt.is_floating_point and
            x.dtype.is_floating_point and dt.itemsize < x.dtype.itemsize)


def _is_mask_partial(p) -> bool:
    return type(p).__name__ in ("MaskPartial", "_MaskPartial")


class ShardingGaps(TorchDispatchMode):
    """Gaps of DTensor's strategies, each bridged with a redistribution
    (whose collectives the recorder counts) or a rule of each rank's
    block, and counted in ``counts`` under its op's name; the torch
    release that needs each (2.11: the card machine's; 2.13):

    * a view DTensor refuses for a sharded dim (both releases: a split
      that does not divide, as 896 = 14 heads x 64 over 16 ranks, whose
      heads the rules replicate too (``head_axis``); 2.11 also: a merge
      of a split dim into the dim before it, the sequence-parallel
      residual's rows flattened for a product that gathers them anyway,
      where 2.13 keeps a strided split): the fewest of the dims the view
      changes are replicated first (:meth:`_view_replicating`);
    * a view of a DTensor whose block is laid out otherwise than its
      strides say (some backward products): of a contiguous copy of the
      block;
    * a pad (2.11's strategy returns a spec of the wrong length; the
      bucketed logits' vocabulary on both): on each rank's block, a
      partial sum summed and a padded dim's split moved first, each to
      the largest unpadded dim it divides (:meth:`_pad_locally`);
    * a new tensor of another shape than its input (both: a gather's
      gradient, zeros of the logits' shape, which DTensor replicates):
      split as its input on the dims they share (:meth:`_new_as_input`);
    * an accumulating indexed add into a replicated tensor (an embedding
      lookup's gradient) whose strategy fails (2.11): partial sums of
      each rank's rows, summed (:meth:`_index_put_as_partial_sum`);
    * an index whose dim two mesh dims split (2.11: the tokens over
      ("pod", "data") of an embedding lookup): the index split once and
      gathered on the other mesh dim (:meth:`_index_split_once`);
    * an op that asks a split operand to become a partial sum (2.11
      cannot redistribute Shard to Partial: the MoE decode's residual
      add): the partial operand summed first, into the split
      (:meth:`_partial_summed_first`);
    * an arg-max or -min that fails (a batch of 1 over 16 ranks): over
      the replicated input;
    * a result held as a masked partial sum (a lookup into a sharded
      dim, ``gather`` over the vocabulary): summed at once, since DTensor
      keeps the mask at the result's shape, which a later view breaks.

    A dispatch mode, so it also acts in the backward's recomputation.
    Any other failure raises: an op with no strategy fails the record."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        name = func._schema.name.partition("::")[2]
        if name == "constant_pad_nd":
            return self._pad_locally(func, args, kwargs)
        if name in ("new_zeros", "new_empty"):
            out = self._new_as_input(func, args, kwargs)
            if out is not None:
                self.counts[f"{name} split as its input"] += 1
                return out
        if name == "_to_copy" and _narrows(args[0], kwargs) and \
                any(p.is_partial() for p in args[0].placements):
            # a partial sum cast down rounds each part, not the sum
            # (2.13 casts it as it is; the FL sync's float32 mean)
            self.counts["_to_copy of a partial sum"] += 1
            x = args[0]
            args = (x.redistribute(x.device_mesh, tuple(
                Replicate() if p.is_partial() else p
                for p in x.placements)),) + tuple(args[1:])
        try:
            out = func(*args, **kwargs)
        except RuntimeError as e:
            if name in ("view", "_unsafe_view") and \
                    "redistribut" in str(e):
                out = self._view_replicating(func, args, kwargs, e)
            elif name == "view" and "not compatible" in str(e):
                x = args[0]   # a block laid out otherwise than its DTensor
                out = func(DTensor.from_local(
                    x.to_local().contiguous(), x.device_mesh, x.placements,
                    run_check=False, shape=x.shape, stride=x.stride()),
                    *args[1:], **kwargs)
            elif name == "index_put" and not kwargs:
                out = self._index_put_as_partial_sum(func, *args)
            elif name == "index" and "hybrid" in str(e):
                out = self._index_split_once(func, *args)
            elif "not supported yet" in str(e) and " to P(" in str(e):
                out = self._partial_summed_first(func, args, kwargs, e)
            elif name in ("argmax", "argmin"):
                x = args[0]
                out = func(x.redistribute(
                    x.device_mesh, [Replicate()] * x.device_mesh.ndim),
                    *args[1:], **kwargs)
            else:
                raise
            self.counts[f"{name} of a sharded dim"] += 1
        if isinstance(out, DTensor) and any(map(_is_mask_partial,
                                                out.placements)):
            self.counts[f"masked partial {name}"] += 1
            out = out.redistribute(out.device_mesh, tuple(
                Replicate() if _is_mask_partial(p) else p
                for p in out.placements))
        return out

    def _pad_locally(self, func, args, kwargs):
        """The pad of ``args[0]`` on each rank's block (some releases'
        DTensor strategy for a pad returns a spec of the wrong length).
        Before it, a partial sum is summed (the pad of the parts is not
        the part of the pad), then a mesh dim that shards a padded dim
        moves its split; each to the largest unpadded dim it divides
        (the padded logits' vocabulary to their rows), so no rank holds
        the padded dim whole over the other dims.  Only where no dim
        takes it is the mesh dim replicated."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        x, pad = args[0], list(args[1])
        mesh = x.device_mesh
        shape = list(x.shape)
        for i in range(len(pad) // 2):
            shape[x.ndim - 1 - i] += pad[2 * i] + pad[2 * i + 1]
        padded = {d for d in range(x.ndim) if shape[d] != x.shape[d]}
        place = list(x.placements)
        for j, p in enumerate(place):
            if not (p.is_partial() or isinstance(p, Shard) and
                    p.dim in padded):
                continue
            parts = [math.prod(mesh.size(k) for k, q in enumerate(place)
                               if k != j and q == Shard(d))
                     for d in range(x.ndim)]
            fit = [d for d in range(x.ndim) if d not in padded and
                   shape[d] % (parts[d] * mesh.size(j)) == 0]
            place[j] = Shard(max(fit, key=lambda d: shape[d] // parts[d])) \
                if fit else Replicate()
        place = tuple(place)
        if place != tuple(x.placements):
            self.counts["constant_pad_nd of a sharded dim"] += 1
            # the sums first: a split that moves then moves 1/n of it
            x = x.redistribute(mesh, tuple(
                q if p.is_partial() else p
                for p, q in zip(x.placements, place))).redistribute(
                    mesh, place)
        out = func(x.to_local(), *args[1:], **kwargs)
        return DTensor.from_local(out, mesh, place, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_strides(shape))

    @staticmethod
    def _new_as_input(func, args, kwargs):
        """A new tensor of another shape than its input ``args[0]`` (a
        gather's gradient: zeros of the logits' shape from a gradient of
        the shape of its index), split as the input on each dim the two
        share, or None where they share no split dim.  DTensor's strategy
        replicates it (the whole (B, C, V) logits on every rank); its
        values are the same under any placement."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        x, size = args[0], torch.Size(args[1])
        mesh = x.device_mesh
        place = tuple(p if isinstance(p, Shard) and len(size) == x.ndim
                      and size[p.dim] == x.shape[p.dim] else Replicate()
                      for p in x.placements)
        if size == x.shape or all(p == Replicate() for p in place):
            return None
        shape, _ = compute_local_shape_and_global_offset(size, mesh, place)
        return DTensor.from_local(
            func(x.to_local(), shape, *args[2:], **kwargs), mesh, place,
            run_check=False, shape=size,
            stride=contiguous_strides(size))

    @staticmethod
    def _index_put_as_partial_sum(func, x, indices, values,
                                  accumulate=False):
        """An accumulating indexed add (the gradient of an embedding
        lookup) into a replicated ``x`` with its indices and values
        sharded alike on their leading dim: each rank adds its own rows
        into zeros, the partial sums are summed over those mesh dims and
        added to ``x`` (some releases fail this op's strategy)."""
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        mesh = x.device_mesh
        (idx,) = indices
        if not accumulate or any(p != Replicate() for p in x.placements):
            raise RuntimeError("no local rule for this index_put")
        rows = tuple(Shard(0) if p == q == Shard(0) else Replicate()
                     for p, q in zip(idx.placements, values.placements))
        part = func(torch.zeros_like(x.to_local()),
                    [idx.redistribute(mesh, rows).to_local()],
                    values.redistribute(mesh, rows).to_local(), True)
        part = DTensor.from_local(
            part, mesh, tuple(Partial() if p == Shard(0) else Replicate()
                              for p in rows), run_check=False)
        return x + part.redistribute(mesh, x.placements)

    @staticmethod
    def _index_split_once(func, x, indices):
        """``x[idx]`` where two mesh dims split one dim of the index
        (2.11's strategy fails for it: the tokens over ("pod", "data")):
        the index keeps the first mesh dim's split of each dim and is
        gathered on the others (its bytes are the tokens'), and DTensor
        takes the op from there (the table keeps its own split on those
        mesh dims, as 2.13's strategy keeps it)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        new = []
        for idx in indices:
            if isinstance(idx, DTensor):
                split, place = set(), []
                for p in idx.placements:
                    twice = isinstance(p, Shard) and p.dim in split
                    place.append(Replicate() if twice else p)
                    if isinstance(p, Shard):
                        split.add(p.dim)
                if tuple(place) == tuple(idx.placements):
                    raise RuntimeError("no bridge for this index")
                idx = idx.redistribute(idx.device_mesh, place)
            new.append(idx)
        return func(x, new)

    @staticmethod
    def _partial_summed_first(func, args, kwargs, err):
        """An op whose strategy asks a split operand to become a partial
        sum, which 2.11 cannot redistribute: the partial sums are summed
        first, into the split of an operand of the same shape that is
        split on that mesh dim (a reduce-scatter), else whole (an
        all-reduce), and DTensor takes the op from there."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        dts = [a for a in args if isinstance(a, DTensor)]
        new, summed = list(args), False
        for i, a in enumerate(args):
            if not (isinstance(a, DTensor) and
                    any(p.is_partial() for p in a.placements)):
                continue
            summed = True
            new[i] = a.redistribute(a.device_mesh, tuple(
                next((b.placements[j] for b in dts if b.shape == a.shape
                      and isinstance(b.placements[j], Shard)), Replicate())
                if p.is_partial() else p
                for j, p in enumerate(a.placements)))
        if not summed:
            raise err
        return func(*new, **kwargs)

    @staticmethod
    def _view_replicating(func, args, kwargs, err):
        """The view of ``args[0]`` with the fewest of its sharded dims
        replicated: the mesh dims that shard a dim the view changes are
        replicated one at a time, the innermost tensor dim first (a
        merge of dims keeps the leading dim's sharding)."""
        from torch.distributed.tensor import Replicate, Shard
        x, new = args[0], tuple(args[1])
        lead = 0
        while lead < min(x.ndim, len(new)) and x.shape[lead] == new[lead]:
            lead += 1
        place = list(x.placements)
        while True:
            changed = [j for j, p in enumerate(place)
                       if isinstance(p, Shard) and p.dim >= lead]
            if not changed:
                raise err
            j = max(changed, key=lambda j: place[j].dim)
            place[j] = Replicate()
            try:
                return func(x.redistribute(x.device_mesh, tuple(place)),
                            *args[1:], **kwargs)
            except RuntimeError as e:
                if "redistribut" not in str(e):
                    raise
                err = e


def _mem_tracker():
    """A MemTracker of the ops on the local blocks alone.  DTensor's
    sharding propagation runs some ops (a view's) on fake tensors at the
    global shape, under a fake mode of its own: torch 2.13's MemTracker
    skips them, 2.11's counts them (the whole (B, S, V) logits of a
    prefill, 297 GiB a rank).  Ops under another fake mode than the one
    active on entry are run untracked, on every release."""
    from torch._guards import active_fake_mode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class LocalMemTracker(MemTracker):
        def __enter__(self):
            self._entry_fake_mode = active_fake_mode()
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(t is DTensor for t in types) and \
                    active_fake_mode() is not self._entry_fake_mode:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def _peak(mt) -> int:
    return max((snap.get("Total", 0) for snap in
                mt.get_tracker_snapshot("peak").values()), default=0)


def run_recorded(step, *args):
    """``step(*args)`` (a :func:`sharded_step`) on DTensors, recording
    its collectives and rank 0's peak bytes.  Returns (out, recorder,
    the step's gap counts, peak bytes)."""
    from torch.distributed.tensor import DTensor
    rec, mt = CollectiveRecorder(), _mem_tracker()
    mt.track_external(*[t.to_local() if isinstance(t, DTensor) else t
                        for t in _leaves(list(args)) if torch.is_tensor(t)])
    step.gaps.counts.clear()
    with mt, rec:   # the step's own gaps mode acts first, rec sees its
        out = _settled(step(*args))   # collectives
    return out, rec, Counter(step.gaps.counts), _peak(mt)


def _settled(tree):
    """Every pending (partial) sum of the step's outputs summed: a
    step's result is its value, whether or not an op forced the sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if isinstance(tree, dict):
        return {k: _settled(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_settled(v) for v in tree)
    if isinstance(tree, DTensor) and any(isinstance(p, Partial)
                                         for p in tree.placements):
        return tree.redistribute(tree.device_mesh, tuple(
            Replicate() if isinstance(p, Partial) else p
            for p in tree.placements))
    return tree


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------

def sharded_step(fn):
    """``fn`` for DTensor arguments: the plain tensors it makes
    (positions, masks) are taken as replicated where they meet a
    DTensor, and :class:`ShardingGaps` bridges DTensor's gaps (its
    counts: ``step.gaps.counts``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    gaps = ShardingGaps()

    def step(*args):
        with implicit_replication(), gaps:
            return fn(*args)

    step.gaps = gaps
    return step


def build(cfg, shape_name: str, mesh):
    """Returns (step_fn, (param specs, input specs), (param pspecs,
    input pspecs), info), as the reference's ``build``: the step of the
    shape's kind from ``launch/steps.py``, to run on DTensors placed by
    the specs (:func:`place`).  Installs the sharding hook."""
    specs = input_specs(cfg, shape_name)
    p_specs = param_specs(cfg)
    shape = INPUT_SHAPES[shape_name]
    decode_tp = shape.kind == "decode" and shp.use_decode_tp(cfg, mesh,
                                                             p_specs)
    p_pspecs = shp.param_pspecs(cfg, mesh, p_specs, decode_tp=decode_tp)
    b_pspecs = shp.batch_pspecs(cfg, mesh, specs)
    set_activation_sharding(shp.sharding_hook(cfg, mesh))
    if shape.kind == "train":
        fn = make_train_step(cfg)
    elif shape.kind == "prefill":
        c_specs = shp.batch_pspecs(
            cfg, mesh, {"cache": kvcache.cache_specs(
                cfg, shape.global_batch, shape.seq_len)})["cache"]
        fn = make_prefill_step(cfg, shape.seq_len, init_cache=partial(
            placed_zeros(mesh, c_specs), cfg))
    else:
        fn = make_decode_step(cfg)
    return (sharded_step(fn), (p_specs, specs), (p_pspecs, b_pspecs),
            {"decode_tp": decode_tp})


def serve_on_mesh(cfg, params, mesh, prompts, gen: int, extra=None,
                  after_prefill=None):
    """Greedy tokens (B, gen) of ``prompts`` (B, S) through the normal
    prefill and decode steps (``launch/steps.py``) on ``mesh``: the
    parameters placed by ``param_pspecs``, the prompts by
    ``batch_pspecs``, the cache by ``cache_pspecs``, the sharding hook
    installed for the run.  ``extra``: the step's other inputs (a
    cross-attention config's ``enc_out``).  ``after_prefill()`` is
    called once the prefill has run.  The serve's greedy loop (``launch/serve.py``) on
    sharded tensors."""
    B, S = prompts.shape
    total = S + gen
    p_placed = place(mesh, params, shp.param_pspecs(cfg, mesh, params))
    batch = dict(extra or {}, tokens=prompts)
    batch = place(mesh, batch, shp.batch_pspecs(cfg, mesh, batch))
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    c_specs = shp.batch_pspecs(
        cfg, mesh, {"cache": kvcache.cache_specs(cfg, B, total)})["cache"]
    prefill = sharded_step(make_prefill_step(
        cfg, total, init_cache=partial(placed_zeros(mesh, c_specs), cfg)))
    decode = sharded_step(make_decode_step(cfg))
    set_activation_sharding(shp.sharding_hook(cfg, mesh))
    try:
        with torch.no_grad():
            logits, cache = prefill(p_placed, batch)
            if after_prefill is not None:
                after_prefill()
            nxt = torch.argmax(logits, dim=-1)
            outs = [nxt]
            for _ in range(gen - 1):
                nxt, cache = decode(p_placed, dict(
                    extra, tokens=nxt[:, None], cache=cache))
                outs.append(nxt)
    finally:
        set_activation_sharding(None)
    return torch.stack([o.full_tensor() for o in outs], dim=1)


def _decode_pos(specs: dict, seq_len: int) -> dict:
    """A decode batch's cache pointer as the step takes it (a Python
    int): the last slot, so the token attends to a full cache."""
    if "cache" not in specs:
        return specs
    return dict(specs, cache=dict(specs["cache"], pos=seq_len - 1))


def _mesh_name(multi_pod: bool, host: bool = False) -> str:
    return "1x1" if host else ("2x16x16" if multi_pod else "16x16")


def dry_run_combo(arch: str, shape_name: str, multi_pod: bool,
                  save: bool = True, verbose: bool = True,
                  donate: bool = False, cfg=None, out_dir=None,
                  host: bool = False) -> dict:
    """One (arch, shape, mesh) record.  ``cfg`` overrides the arch's
    config (a test's small widths); ``host`` takes the one-rank host
    mesh (its peak is what one card would hold); ``donate`` names the
    record apart, as the reference's (the port's decode step writes its
    cache in place: there is nothing to donate)."""
    cfg = cfg or get_config(arch)
    mesh_name = _mesh_name(multi_pod, host) + ("+donate" if donate else "")
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not cfg.supports_shape(shape_name):
        record["status"] = "skipped"
        record["reason"] = ("long_500k needs sub-quadratic attention; "
                            f"{arch} is dense full-attention (DESIGN.md §4)")
        _save(record, save, out_dir)
        return record

    start_fake_world()
    mesh = (make_host_mesh(device=MESH_DEVICE) if host else
            make_production_mesh(multi_pod=multi_pod, device=MESH_DEVICE))
    chips = mesh.size()
    shape = INPUT_SHAPES[shape_name]
    t0 = time.time()
    try:
        fn, (p_specs, specs), (p_pspecs, b_pspecs), binfo = build(
            cfg, shape_name, mesh)
        params = place(mesh, p_specs, p_pspecs)
        batch = place(mesh, _decode_pos(specs, shape.seq_len), b_pspecs)
        grad = torch.enable_grad() if shape.kind == "train" \
            else torch.no_grad()
        with grad:
            out, rec, reshards, peak = run_recorded(fn, params, batch)
        coll = collective_bytes_from_log(rec.records,
                                         pod_size=256 if multi_pod else 0)
        arg_b = _local_bytes(params) + _local_bytes(batch)
        out_b = _local_bytes(list(out))
        tmp_b = max(peak - arg_b, 0)
        n_active = active_count_from_specs(cfg, p_specs)
        af = analytic_flops(cfg, shape, n_active)
        traffic = arg_b + out_b + 2 * tmp_b
        terms = roofline_terms(af / chips, traffic, coll["total"], chips,
                               PEAK_FLOPS_BF16, HBM_BW, NVLINK_BW)
        mf = model_flops(cfg, p_specs, shape_name)
        record.update({
            "status": "ok",
            "chips": chips,
            # nothing is lowered or compiled: no compile time, no HLO
            "compile_s": None,
            "hlo_flops_per_device_loop_once": None,
            "hlo_bytes_per_device_loop_once": None,
            "run_s": round(time.time() - t0, 1),
            "analytic_flops_total": af,
            "hbm_traffic_model_bytes": traffic,
            "collective_bytes_per_device": coll["total"],
            "cross_pod_bytes_per_device": coll["cross_pod"],
            "collective_breakdown": {k: v for k, v in coll.items()
                                     if k not in ("total", "counts")},
            "collective_counts": coll["counts"],
            "reshards": dict(reshards),
            "memory": {
                "argument_bytes": arg_b,
                "output_bytes": out_b,
                "temp_bytes": tmp_b,
                "memtracker_peak_bytes": peak,
            },
            "decode_tp": binfo["decode_tp"],
            "roofline": terms,
            "dominant": dominant_term(terms),
            "model_flops_total": mf,
            "model_flops_ratio": mf / af if af else None,
        })
        if verbose:
            print(f"[ok] {arch} {shape_name} {mesh_name}: "
                  f"run={record['run_s']}s "
                  f"args/device={arg_b / 2**30:.3f}GiB "
                  f"peak/device={peak / 2**30:.3f}GiB "
                  f"coll/device={coll['total'] / 2**20:.2f}MiB "
                  f"dom={record['dominant']}", flush=True)
    except Exception as e:  # noqa: BLE001 — the record keeps the failure
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-6000:]
        if verbose:
            print(f"[ERROR] {arch} {shape_name} {mesh_name}: "
                  f"{record['error'][:300]}", flush=True)
    finally:
        set_activation_sharding(None)
    _save(record, save, out_dir)
    return record


SEED_BATCH = (32, 512)   # the FD sync's seed sequences (batch, length)


def _seed_batch(cfg):
    b, s = SEED_BATCH
    dt = getattr(torch, cfg.param_dtype)
    if cfg.embed_input:
        seed = {"embeds": torch.empty((b, s, cfg.d_model), dtype=dt,
                                      device="meta"),
                "labels": torch.empty((b, s), dtype=torch.int32,
                                      device="meta")}
    else:
        seed = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                      device="meta")}
    if cfg.cross_attention:
        seed["enc_out"] = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                                      dtype=dt, device="meta")
    return seed


def pod_fd_sync(cfg, mesh, ks_iters: int = 4):
    """The FD sync as the pods run it on the ("pod", "data", "model")
    mesh: the (NB, NB) uplink tables, placed one a pod, are averaged over
    "pod" (``make_fd_sync_step``'s mean: the one cross-pod collective),
    then each pod converts its own replica on its own (data, model)
    block of the mesh with ``make_fd_sync_step(cfg, n_pods=1)``, its
    activations on that block alone (the reference's vmap over pods
    with ``exclude_pod``).  Returns ``fd_sync(pod_params, pod_favg,
    seed_batch)`` for this rank's pod: ``pod_params`` leaves (1, ...) on
    the pod's block, ``pod_favg`` (n_pods, NB, NB) on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    inner = make_fd_sync_step(cfg, n_pods=1, ks_iters=ks_iters)
    block = mesh["data", "model"]

    def fd_sync(pod_params, pod_favg, seed_batch):
        gout = pod_favg.mean(0).redistribute(
            mesh, [Replicate()] * mesh.ndim)              # the uplink
        gout = DTensor.from_local(gout.to_local(), block,
                                  [Replicate()] * block.ndim,
                                  run_check=False)
        return inner(pod_params, gout[None], seed_batch)

    return fd_sync


def dry_run_sync_steps(arch: str, save: bool = True, cfg=None,
                       out_dir=None) -> list:
    """The multi-pod federated syncs on the 2 x 16 x 16 mesh: the FL
    full-parameter mean over the pods against the paper's FD sync
    (:func:`pod_fd_sync`).  Their cross-pod bytes are the uplink.  The
    seed batch (:data:`SEED_BATCH`) is on every pod, over its "data"."""
    cfg = cfg or get_config(arch)
    start_fake_world()
    mesh = make_production_mesh(multi_pod=True, device=MESH_DEVICE)
    n_pods, chips = 2, mesh.size()
    block = mesh["data", "model"]
    p_specs = param_specs(cfg)
    pspecs = shp.param_pspecs(cfg, mesh, p_specs)
    nb = cfg.fd_buckets
    seed = _seed_batch(cfg)

    def stacked(n):
        return tree_map(lambda t: t.new_empty((n,) + t.shape), p_specs)

    records = []
    for name in ("fl_sync", "fd_sync"):
        fd = name == "fd_sync"
        set_activation_sharding(shp.sharding_hook(
            cfg, block if fd else mesh, exclude_pod=fd))
        rec = {"arch": arch, "shape": name, "mesh": "2x16x16"}
        t0 = time.time()
        try:
            if not fd:
                fn = make_fl_sync_step(cfg, n_pods)
                args = (place(mesh, stacked(n_pods),
                              tree_map(lambda s: shp.P("pod", *s), pspecs)),)
            else:
                fn = pod_fd_sync(cfg, mesh)
                favg = torch.empty((n_pods, nb, nb), device="meta")
                args = (place(block, stacked(1),
                              tree_map(lambda s: shp.P(None, *s), pspecs)),
                        place(mesh, favg, shp.P("pod", None, None)),
                        place(block, seed, shp.batch_pspecs(cfg, block,
                                                            seed)))
            _, log, reshards, peak = run_recorded(sharded_step(fn), *args)
            coll = collective_bytes_from_log(log.records, pod_size=256)
            rec.update({
                "status": "ok", "chips": chips,
                # nothing is lowered or compiled: no compile time, no HLO
                "compile_s": None,
                "hlo_flops_per_device": None,
                "hlo_bytes_per_device": None,
                "run_s": round(time.time() - t0, 1),
                "argument_bytes_per_device": _local_bytes(list(args)),
                "memtracker_peak_bytes": peak,
                "collective_bytes_per_device": coll["total"],
                "cross_pod_bytes_per_device": coll["cross_pod"],
                "collective_breakdown": {k: v for k, v in coll.items()
                                         if k not in ("total", "counts")},
                "collective_counts": coll["counts"],
                "reshards": dict(reshards),
            })
            print(f"[ok] {arch} {name}: run={rec['run_s']}s "
                  f"coll/device={coll['total'] / 2**20:.2f}MiB "
                  f"cross-pod={coll['cross_pod'] / 2**20:.3f}MiB",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — the record keeps the failure
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-6000:]
            print(f"[ERROR] {arch} {name}: {rec['error'][:300]}", flush=True)
        finally:
            set_activation_sharding(None)
        _save(rec, save, out_dir)
        records.append(rec)
    return records


def _save(record: dict, save: bool, out_dir=None) -> None:
    if not save:
        return
    out = Path(out_dir or RESULTS_DIR)
    out.mkdir(parents=True, exist_ok=True)
    name = f"{record['arch']}_{record['shape']}_{record['mesh']}.json"
    with open(out / name, "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all (arch x shape) for the selected mesh")
    ap.add_argument("--sync-steps", action="store_true",
                    help="run the multi-pod FL/FD sync steps")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--host-mesh", action="store_true",
                    help="the one-rank (1, 1) host mesh")
    ap.add_argument("--donate", action="store_true",
                    help="name the records apart (the port's decode "
                         "writes its cache in place)")
    ap.add_argument("--out", default=None,
                    help=f"records directory (default {RESULTS_DIR})")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs(assigned_only=True)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    out_dir = Path(args.out or RESULTS_DIR)

    if args.sync_steps:
        for a in archs:
            dry_run_sync_steps(a, out_dir=out_dir)
        return
    n_ok = n_err = 0
    for a in archs:
        for s in shapes:
            mesh_name = _mesh_name(args.multi_pod, args.host_mesh) + \
                ("+donate" if args.donate else "")
            path = out_dir / f"{a}_{s}_{mesh_name}.json"
            if args.skip_existing and path.exists():
                with open(path) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        continue
            rec = dry_run_combo(a, s, args.multi_pod, donate=args.donate,
                                out_dir=out_dir, host=args.host_mesh)
            n_ok += rec["status"] in ("ok", "skipped")
            n_err += rec["status"] == "error"
    print(f"done: {n_ok} ok/skipped, {n_err} errors")


if __name__ == "__main__":
    main()
