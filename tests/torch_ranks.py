"""Rank workers of the sharded-path tests (``test_torch_sharded*.py``).

``start(fn, world, tmp, *args)`` is ``repro_torch.launch.ranks.
spawn_ranks``: ``world`` gloo ranks started in the background, each
group joined through a file in ``tmp`` (no port, so parallel test
workers never collide); ``spawn`` also waits for their results.  A test
module starts all its worlds first and runs the reference in the parent
while they work.  This module is what a child imports: it imports torch
and the port, never jax or the reference (the parent runs the
reference).
"""
from __future__ import annotations

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.ranks import (_np, sharded_trainer_run,
                                      spawn_ranks as start)


@pytest.fixture(scope="module")
def one_rank_group():
    """The one-rank gloo group the mesh builders start in a process that
    has none (a test module's own), destroyed after the module if it
    started it."""
    from repro_torch.launch.mesh import ensure_process_group
    started = not dist.is_initialized()
    ensure_process_group("cpu")
    yield
    if started and dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, world: int, tmp, *args) -> list:
    return start(fn, world, tmp, *args).results()


def trainer_runs(rank, world, runs, device="cpu") -> list:
    """Each of ``runs`` — ``(FederatedConfig kwargs, ChannelConfig
    kwargs, (dev_x, dev_y, test_x, test_y))`` — sharded over the group on
    ``device``: ``repro_torch.launch.ranks.sharded_trainer_run``'s
    record of each."""
    return [sharded_trainer_run(fc_kw, ch_kw, data, device)
            for fc_kw, ch_kw, data in runs]


def sweep_runs(rank, world, data, runs) -> list:
    """Each of ``runs`` — ``(base FederatedConfig kwargs, grid axes,
    mesh_shape or None)`` — as a sweep on the CPU: its result arrays,
    each group's resolved mesh shape and the runner's 1-D mesh."""
    from repro_torch.channel import ChannelConfig
    from repro_torch.core.program import ProgramOptions
    from repro_torch.core.protocols import FederatedConfig
    from repro_torch.models import CNN
    from repro_torch.sweep import SweepRunner, engine_stats, make_grid
    out = []
    for fc_kw, axes, shape in runs:
        grid = make_grid(FederatedConfig(**fc_kw),
                         ChannelConfig(num_devices=fc_kw["num_devices"],
                                       p_up_dbm=40.0), **axes)
        engine_stats.reset()
        runner = SweepRunner(CNN(), grid, *data, device="cpu",
                             options=ProgramOptions(mesh_shape=shape))
        res = runner.run()
        out.append({"acc": res.acc, "loss": res.loss,
                    "latency_s": res.latency_s, "up_ok": res.up_ok,
                    "converged": res.converged,
                    "programs": engine_stats.programs,
                    "mesh_shapes": [p.mesh_shape for _, _, p in
                                    runner.groups],
                    "runner_mesh": (None if runner.mesh is None else
                                    tuple(runner.mesh.shape))})
    return out


def fd_sync_run(rank, world, cfg, params, favg, seed_batch) -> dict:
    """One ``make_fd_sync_step_shardmap`` sync, one pod a rank: this
    rank's pod of ``params`` (numpy leaves, a leading pod axis) and of
    ``favg`` (n_pods, NB, NB)."""
    from repro_torch.launch.mesh import COLLECTIVES, make_mesh
    from repro_torch.launch.steps import make_fd_sync_step_shardmap
    from repro_torch.models.transformer import tree_map
    mesh = make_mesh((world,), ("pod",), device="cpu")
    sync = make_fd_sync_step_shardmap(cfg, mesh)
    mine = tree_map(lambda a: torch.from_numpy(a[rank:rank + 1].copy()),
                    params)
    batch = {k: torch.from_numpy(v) for k, v in seed_batch.items()}
    COLLECTIVES.reset()
    new, gout = sync(mine, torch.from_numpy(favg[rank:rank + 1].copy()),
                     batch)
    return {"params": tree_map(lambda t: _np(t), new), "gout": _np(gout),
            "records": list(COLLECTIVES.records)}


def launcher_rank(rank, world, port, tmp):
    """A rank as ``torchrun`` starts it: the environment names the world
    and no group is running.  The mesh builder must join that world
    (``env://``) and not start a one-rank group of its own; the rank's
    world size, mesh, backend and an all-reduce go to ``tmp``."""
    import os
    import pickle

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import (all_reduce_sum, make_device_mesh,
                                         world_size)
    m = make_device_mesh(4, device="cpu")
    out = {"world": world_size(), "mesh": tuple(m.shape),
           "backend": dist.get_backend(),
           "sum": float(all_reduce_sum(torch.tensor([rank + 1.0]))[0])}
    dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
