"""Ranks spawned on one host, and what a rank keeps of a sharded run.

``spawn_ranks(fn, world, tmp, *args)`` starts ``world`` processes with
the ``spawn`` start method and returns at once; each takes one intra-op
thread, joins a gloo group through a file in ``tmp`` (no port, so
parallel jobs never collide), runs ``fn(rank, world, *args)`` and
pickles its result; ``.results()`` waits and returns them in rank order.
``fn`` must be importable in the child (a module's top-level function).
On a GPU every rank may share one card: gloo carries CUDA tensors, NCCL
refuses two ranks on one device.

:func:`record_rounds` keeps each round's replicated state of a trainer,
and :func:`sharded_trainer_run` runs one ``shard_devices`` trainer on
the group there is and returns what the checks read.
:func:`emulated_shards` makes an unsharded trainer compute, in one
process and with code of its own, what two ranks of its sharded path
compute: the oracle that holds the sharded path bit for bit where its
result differs from the vmapped run's.
"""
from __future__ import annotations

import contextlib
import pickle
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HISTORY_KEYS = ("acc", "loss", "round_latency_s", "uplink_ok",
                "converged_round", "seeds")


def _main(rank, world, tmp, fn):
    torch.set_num_threads(1)
    args = pickle.loads((Path(tmp) / "args.pkl").read_bytes())
    dist.init_process_group("gloo", init_method=f"file://{tmp}/group",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


class Ranks:
    """``world`` ranks started by :func:`spawn_ranks`, running in the
    background; :meth:`results` waits for them."""

    def __init__(self, fn, world: int, tmp, args):
        self.world, self.tmp = world, Path(tmp)
        self.tmp.mkdir(parents=True, exist_ok=True)
        # the arguments go through a file: a spawned child reads its pipe
        # only once it has imported torch, so large arguments on the pipe
        # would hold each start until the child before it had booted
        (self.tmp / "args.pkl").write_bytes(pickle.dumps(args))
        self._ctx = mp.start_processes(
            _main, args=(world, str(self.tmp), fn), nprocs=world,
            join=False, start_method="spawn")
        self._out = None

    def results(self) -> list:
        if self._out is None:
            while not self._ctx.join():
                pass
            self._out = [pickle.loads((self.tmp / f"rank{r}.pkl")
                                      .read_bytes())
                         for r in range(self.world)]
        return self._out


def spawn_ranks(fn, world: int, tmp, *args) -> Ranks:
    return Ranks(fn, world, tmp, args)


def _np(t):
    return t.detach().cpu().numpy()


def record_rounds(trainer) -> list:
    """Wrap ``trainer.round_once`` (the instance's, which the round
    program calls) to keep each round's replicated state on the host:
    the global model flattened, the per-device tables, and the
    collectives' calls and bytes so far."""
    from .mesh import COLLECTIVES
    rounds = []
    round_once = trainer.round_once

    def recorded(*a, **kw):
        state, rec = round_once(*a, **kw)
        rounds.append({"g_params": _np(torch.cat(
                           [t.reshape(-1) for v in state.g_params.values()
                            for t in v.values()])),
                       "dev_gout": _np(state.dev_gout),
                       "calls": COLLECTIVES.calls(),
                       "bytes": COLLECTIVES.bytes()})
        return state, rec

    trainer.round_once = recorded
    return rounds


def sharded_trainer_run(fc_kw: dict, ch_kw: dict, data, device) -> dict:
    """A ``FederatedConfig(shard_devices=True, **fc_kw)`` trainer (its
    model from the registry) run over ``data`` — ``(dev_x, dev_y,
    test_x, test_y)`` — on ``device`` with the process group there is:
    its history (:data:`HISTORY_KEYS`), ``compute_s``, the last tables,
    each round's replicated state, the mesh, the rows of this rank's
    captured local step, the collectives' records and the launches."""
    from ..channel import ChannelConfig
    from ..core.protocols import FederatedConfig, FederatedTrainer
    from ..kernels import runtime
    from .mesh import COLLECTIVES

    tr = FederatedTrainer(None, FederatedConfig(shard_devices=True,
                                                **fc_kw),
                          ChannelConfig(**ch_kw), device=device)
    rounds = record_rounds(tr)
    COLLECTIVES.reset()
    runtime.reset_launch_counts()
    h = tr.run(*data)
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    return {"history": {k: h[k] for k in HISTORY_KEYS},
            "compute_s": list(h["compute_s"]),
            "last_dev_gout": _np(tr.last_dev_gout),
            "rounds": rounds, "mesh": tuple(tr.mesh.shape),
            "step_rows": [b.inputs["idx"].shape[0]
                          for b in tr.local_train.steps.buffers],
            "records": list(COLLECTIVES.records),
            "launches": runtime.launch_counts()}


def _rank_blocks(local_train, rows):
    """``local_train`` run on each block of ``rows`` in turn, the
    results concatenated."""
    def by_blocks(params, x, y, keys, gout, *rest):
        outs = [local_train({k: {m: t[sl] for m, t in v.items()}
                             for k, v in params.items()},
                            x[sl], y[sl], keys[sl], gout[sl], *rest)
                for sl in rows]
        new = {k: {m: torch.cat([o[0][k][m] for o in outs]) for m in v}
               for k, v in params.items()}
        return (new,) + tuple(torch.cat([o[i] for o in outs])
                              for i in (1, 2, 3))
    return by_blocks


def _partial_sums(rows):
    """The trainer's ``weighted_avg`` and ``gout_update`` as one masked
    partial sum a block of ``rows``, the sums added in block order."""
    def masks(like):
        out = []
        for sl in rows:
            m = like.new_zeros(like.shape[0])
            m[sl] = 1.0
            out.append(m)
        return out

    def total(parts):
        acc = parts[0]
        for q in parts[1:]:
            acc = acc + q
        return acc

    def weighted_avg(stacked, weights):
        leaves = [t for v in stacked.values() for t in v.values()]
        flat = total([torch.cat([w.sum().reshape(1)] + [
            torch.tensordot(w, t, dims=1).reshape(-1) for t in leaves])
            for w in (weights * m for m in masks(weights))])
        wsum, i, out = flat[0].clamp_min(1e-9), 1, {}
        for k, v in stacked.items():
            out[k] = {}
            for n, t in v.items():
                size = t[0].numel()
                out[k][n] = flat[i:i + size].reshape(t.shape[1:]) / wsum
                i += size
        return out

    def gout_update(favg, cnt, ok):
        C = favg.shape[-1]
        flat = total([torch.cat([
            torch.einsum("dc,dcm->cm", cw, favg).reshape(-1), cw.sum(0)])
            for cw in (ok[:, None] * cnt * m[:, None]
                       for m in masks(cnt))])
        return flat[:C * C].view(C, C) / flat[C * C:][:, None].clamp_min(1.0)

    return weighted_avg, gout_update


@contextlib.contextmanager
def emulated_shards(trainer, shards: int, blocks: bool = True,
                    psums: bool = True):
    """Within the block, the unsharded ``trainer`` computes the two ways
    in which ``shards`` ranks of its ``shard_devices`` path compute
    otherwise than its vmapped run: ``blocks`` trains each rank's rows
    of the cohort as a local step of their own (the (D/S, B) step a rank
    captures, where cuDNN may choose other algorithms than for D rows),
    ``psums`` sums each aggregation as ``shards`` masked partial sums
    over the whole arrays, added in rank order.  With both, two ranks
    must compute this run bit for bit (gloo adds two ranks' values in
    one addition); the order of more ranks' sums is gloo's own."""
    from ..core import protocols

    D = trainer.fc.cohort_size()
    rows = [slice(r * D // shards, (r + 1) * D // shards)
            for r in range(shards)]
    saved = trainer.local_train, protocols.weighted_avg, \
        protocols.gout_update
    if blocks:
        trainer.local_train = _rank_blocks(trainer.local_train, rows)
    if psums:
        protocols.weighted_avg, protocols.gout_update = _partial_sums(rows)
    try:
        yield trainer
    finally:
        trainer.local_train, protocols.weighted_avg, \
            protocols.gout_update = saved
