"""The sweep runner: a :class:`~repro_torch.sweep.axes.SweepGrid` as one
program per group of points that share their structure (protocol, codec
family, cohort size, model, task).

Within a group the G points run stacked, G x D device rows: point g's
device d is row ``g D + d`` of the local step, whose parameters have
leaves (G D, ...).  A local SGD step of the whole group is one replay
of one captured step (one grouped convolution, one ``distill_step``
launch with each row's own beta), the eq. (5) conversion one replay of
one captured step over the G stacked server models (each with its own
eta, beta, seed set and step count), and the link draws of the G points
one batched draw.  Every per-point value enters the steps as a tensor,
so one capture serves the group, and :class:`GridRoundProgram` queues
the group's rounds without reading anything back until ``finalize``
(the reference scans its rounds in one compiled program).

What the rounds cannot express is done on the host first, in the order
the loop path uses: each point's init and keys, the round-1 seed
collection through the content-keyed memo (``core/seed_prep.py``;
points that share a seed key share one prep run and one result), the
conversion's step keys for every round, padded to the group's largest
step count, the link budgets and slot counts, and the sampled cohorts.
Points that train on different partitions index one stack of the
group's distinct partitions (ragged ``n_local`` padded, the per-row
``n_local`` bounding every batch draw); points that share one index it
without a copy.

Across ranks (``launch/mesh.py``): a grid of ``shard_devices`` points
splits each group's device axis over a ("data",) mesh, and
``ProgramOptions(mesh_shape=(gs, ds))`` lays each group on a ("grid",
"data") mesh, the shape a budget re-fitted per group to the largest
divisors of its G and cohort size that fit it and the world size.  A
rank trains its block of points and device rows
(:class:`~repro_torch.core.protocols.GridShards`); every reduction stays
over "data", and the rest of a round runs on each rank alike, under
cuDNN's deterministic algorithms on a GPU.

``run_pointwise`` is the per-point ``FederatedTrainer.run`` loop the
sweep replaces, and its equivalence oracle.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import rng
from ..channel.payload import round_slot_plan
from ..core.privacy import GaussianAccountant, gaussian_epsilon
from ..core.program import GridRoundProgram, ProgramOptions
from ..core.protocols import (FLD_FAMILY, FederatedTrainer,  # noqa: F401
                              GridShards, gout_update_psum,
                              make_grid_round_step, weighted_avg_psum)
from ..core.seed_prep import SeedPrepMemo, prepare_seeds
from ..core.state import RoundState
from ..data.pipeline import parse_task
from ..device import deterministic_cudnn, resolve_device
from ..launch.mesh import (_largest_divisor, make_device_mesh,
                           make_grid_mesh, world_size)
from ..registry import MODELS, TASKS
from .axes import SweepGrid
from .results import SweepResult


@dataclasses.dataclass
class EngineStats:
    """``programs`` counts group builds, ``captures`` the captured steps
    the groups' runs created (a new step layout: a CUDA graph on the
    GPU, the eager step on the CPU).  A warm ``run()`` adds neither."""
    programs: int = 0
    captures: int = 0

    def reset(self):
        self.programs = 0
        self.captures = 0


engine_stats = EngineStats()


def _ndim(a) -> int:
    return a.dim() if torch.is_tensor(a) else np.asarray(a).ndim


def _pad_seed_sets(seed_sets, num_classes: int, device=None):
    """Stack ragged per-point seed sets: x (G, N_max, ...), y (G, N_max)
    int64 or (G, N_max, C), live sizes (G,) int64, on ``device`` (default:
    the sets').  Points that share one result object share one padded
    row.  A group that mixes hard and soft labels promotes the hard ones
    to one-hot rows."""
    uniq_of: dict = {}
    uniq, inv = [], []
    for s in seed_sets:
        u = uniq_of.get(id(s))
        if u is None:
            u = uniq_of[id(s)] = len(uniq)
            uniq.append(s)
        inv.append(u)
    xs = [s["train_x"] for s in uniq]
    ys = [s["train_y"] for s in uniq]
    dev = xs[0].device if device is None else torch.device(device)
    n = [x.shape[0] for x in xs]
    n_max = max(n)
    rng.check_span(0, n_max)        # the conversion's batch-draw bound
    px = torch.zeros((len(xs), n_max) + tuple(xs[0].shape[1:]),
                     dtype=torch.float32, device=dev)
    for u, x in enumerate(xs):
        px[u, :n[u]] = x
    if all(y.dim() == 1 for y in ys):
        py = torch.zeros(len(ys), n_max, dtype=torch.int64, device=dev)
    else:
        py = torch.zeros(len(ys), n_max, num_classes, dtype=torch.float32,
                         device=dev)
        ys = [torch.nn.functional.one_hot(y, num_classes).to(torch.float32)
              if y.dim() == 1 else y for y in ys]
    for u, y in enumerate(ys):
        py[u, :n[u]] = y
    inv = torch.as_tensor(inv, device=dev)
    return (px[inv], py[inv],
            torch.as_tensor(n, dtype=torch.int64, device=dev)[inv])


def _stack_partitions(parts):
    """The device partitions of one group's points, ``parts`` a list of
    (dev_x (D, n, ...), dev_y (D, n)) tensor pairs (points that share a
    partition share the objects).  Returns ``(dev_x, dev_y, data_rows,
    n_local)``: one partition as it is, or the distinct ones stacked (N
    D, n_max, ...) with ragged ``n_local`` zero-padded; ``data_rows`` (G,
    D) int64, point g's device d's row; ``n_local`` (G,) numpy."""
    uniq_of: dict = {}
    uniq, inv = [], []
    for x, y in parts:
        u = uniq_of.get(id(x))
        if u is None:
            u = uniq_of[id(x)] = len(uniq)
            uniq.append((x, y))
        inv.append(u)
    n_local = np.asarray([x.shape[1] for x, _ in parts], np.int64)
    x0 = uniq[0][0]
    D, dev = x0.shape[0], x0.device
    if len(uniq) == 1:
        dev_x, dev_y = uniq[0]
    else:
        n_max = max(x.shape[1] for x, _ in uniq)
        dev_x = torch.zeros((len(uniq), D, n_max) + tuple(x0.shape[2:]),
                            dtype=torch.float32, device=dev)
        dev_y = torch.zeros(len(uniq), D, n_max, dtype=torch.int64,
                            device=dev)
        for u, (x, y) in enumerate(uniq):
            dev_x[u, :, :x.shape[1]] = x
            dev_y[u, :, :y.shape[1]] = y
        dev_x = dev_x.reshape((-1,) + tuple(dev_x.shape[2:]))
        dev_y = dev_y.reshape(-1, n_max)
    rows = np.asarray(inv)[:, None] * D + np.arange(D)
    return dev_x, dev_y, torch.as_tensor(rows, device=dev), n_local


def _resolve_partitions(grid: SweepGrid, dev_x, dev_y, num_devices: int,
                        num_classes: int):
    """Per-point (dev_x, dev_y) pairs: each distinct
    :class:`PartitionSpec` built once from the flat sample pool, or the
    given pre-partitioned data shared by every point."""
    if dev_x is None or dev_y is None:
        raise ValueError(
            "grid without a task axis takes explicit data: pass "
            "dev_x/dev_y (and test_x/test_y), or task_data=... / "
            "make_task_data(grid) to draw the base task's procedural "
            "pool")
    if grid.partitioned:
        if _ndim(dev_y) != 1:
            raise ValueError(
                "grids with partition axes take the flat sample pool "
                f"(x (N, ...), y (N,)); got y shape {tuple(dev_y.shape)} "
                "— pass the unpartitioned data and let each point's "
                "PartitionSpec split it")
        built: dict = {}
        for spec in grid.parts:
            if spec not in built:
                built[spec] = spec.build(dev_x, dev_y, num_devices,
                                         num_classes)
        return [built[spec] for spec in grid.parts]
    if _ndim(dev_y) != 2:
        raise ValueError(
            "grids without partition axes take pre-partitioned "
            f"(D, n_local) data; got dev_y shape {tuple(dev_y.shape)}")
    return [(dev_x, dev_y)] * grid.size


def make_task_data(grid: SweepGrid, n_test: int = 200,
                   data_seed: int = 1234, device=None) -> dict:
    """One procedural sample pool and test set per task of a tasked
    grid, on ``device`` (default: the GPU): ``{task: (pool_x, pool_y,
    test_x, test_y)}``, the pool sized for the largest partition a point
    of the task asks for, drawn from ``fold_in(PRNGKey(data_seed),
    TASKS.index(task))`` as the reference draws it."""
    if not grid.partitioned:
        raise ValueError("make_task_data needs a partitioned grid "
                         "(task axes always are)")
    dev = resolve_device(device)
    out = {}
    for task, idxs in grid.task_groups().items():
        spec = parse_task(task)
        fc0 = grid.points[idxs[0]][0]
        n_pool = max(grid.points[g][0].num_devices * grid.parts[g].n_local
                     for g in idxs)
        key = rng.fold_in(rng.PRNGKey(data_seed, dev),
                          TASKS.index(spec.name))
        x, y = spec.data(key, n_pool + n_test, fc0.num_classes, device=dev)
        out[task] = (x[:n_pool], y[:n_pool], x[n_pool:], y[n_pool:])
    return out


def _resolve_task_partitions(grid: SweepGrid, task_data: dict):
    """Per-point (dev_x, dev_y) of a tasked grid: each distinct (task,
    PartitionSpec) built once from that task's pool."""
    missing = set(grid.task_groups()) - set(task_data)
    if missing:
        raise ValueError(f"task_data is missing pools for {sorted(missing)}")
    built: dict = {}
    parts = []
    for (fc, _), spec in zip(grid.points, grid.parts):
        key = (fc.task, spec)
        if key not in built:
            px, py = task_data[fc.task][:2]
            built[key] = spec.build(px, py, fc.num_devices, fc.num_classes)
        parts.append(built[key])
    return parts


def _group_models(model, fc):
    """One group's models: ``(global model, arch_models)``, arch_models
    None for a homogeneous cohort, else ``[(name, device indices,
    model), ...]`` with the server's architecture (device 0's) first."""
    if model is not None:
        return model, None
    models = fc.build_models()
    groups = fc.arch_groups()
    gmodel = models[fc.server_model()]
    if groups is None:
        return gmodel, None
    if groups[0][0] != fc.server_model():
        raise ValueError(
            "grid programs require device 0 to run the server "
            f"architecture ({fc.server_model()!r}); the partition "
            f"starts with {groups[0][0]!r}")
    return gmodel, [(a, idx, models[a]) for a, idx in groups]


def _stack_trees(trees):
    return {k: {m: torch.stack([t[k][m] for t in trees]) for m in v}
            for k, v in trees[0].items()}


def _broadcast(tree, n: int):
    """Leaves (G, ...) -> (G, n, ...), each device its point's copy."""
    return {k: {m: t[:, None].expand((t.shape[0], n) + tuple(t.shape[1:]))
                .clone() for m, t in v.items()} for k, v in tree.items()}


class _ProtocolProgram:
    """One group's program: its points' host prep, the stacked constants
    and per-round inputs on the device, the group's
    :class:`~repro_torch.core.protocols.GridRoundStep` and the
    :class:`GridRoundProgram` that queues its rounds."""

    def __init__(self, model, grid: SweepGrid, proto: str, idxs, parts,
                 test_x, test_y, memo: SeedPrepMemo, device,
                 codec: str = "identity", cohort_size: Optional[int] = None,
                 arch_models: Optional[list] = None,
                 options: Optional[ProgramOptions] = None, mesh=None):
        engine_stats.programs += 1
        dev = device
        fc0, ch0 = grid.points[idxs[0]]
        self.idxs = idxs
        self.codec = codec
        options = options or ProgramOptions()
        points = [grid.points[i] for i in idxs]
        G, D, C, R = len(idxs), fc0.num_devices, fc0.num_classes, \
            fc0.max_rounds
        Dc = D if cohort_size is None else min(int(cohort_size), D)
        sampled = Dc < D
        if options.mesh_shape is not None:
            # the (grid, data) mesh: the requested shape is a budget,
            # re-fitted to this group's G and cohort and the world size
            avail = world_size()
            gs = _largest_divisor(G, min(options.mesh_shape[0], avail))
            ds = _largest_divisor(Dc, min(options.mesh_shape[1],
                                          avail // gs))
            mesh = make_grid_mesh(G, Dc, shape=(gs, ds), device=dev)
        elif sampled and mesh is not None:
            # the mesh spans the cohort, as the sampled trainer's
            mesh = make_device_mesh(Dc, fc0.mesh_shards or None, device=dev)
        self.mesh = mesh
        self.mesh_shape = tuple(mesh.shape) if mesh is not None else None
        dev_x, dev_y, data_rows, n_local = _stack_partitions(parts)
        rng.check_span(0, int(n_local.max()))  # the local batch-draw bound
        feat = tuple(dev_x.shape[2:])

        # ---- host prep, per point in the loop path's key order ----
        run_keys, inits, conv_keys, seed_sets = [], [], [], []
        arch_inits = {a: [] for a, _, _ in (arch_models or [])[1:]}
        plans = []
        specs = [fc.codec_spec() for fc, _ in points]
        k_max = max(fc.server_iters for fc, _ in points)
        gather_cache: dict = {}
        for (fc, ch), spec, (px, py) in zip(points, specs, parts):
            kinit, key = rng.split(rng.PRNGKey(fc.seed, dev), 2)
            run_keys.append(key)
            params = model.init(kinit)
            inits.append(params)
            for a, _, m in (arch_models or [])[1:]:
                arch_inits[a].append(m.init(
                    rng.fold_in(kinit, MODELS.index(a) + 1)))
            if proto in FLD_FAMILY:
                spx, spy = px, py
                if sampled:
                    # round 1 collects from the round-1 cohort; gathers
                    # are shared by (partition, cohort) so the memo still
                    # sees one object per content
                    c1 = fc.sampler.cohort(fc.seed, 1, D)
                    ckey = (id(px), c1.tobytes())
                    if ckey not in gather_cache:
                        jdx = torch.as_tensor(c1, device=dev)
                        gather_cache[ckey] = (px[jdx], py[jdx])
                    spx, spy = gather_cache[ckey]
                kr1 = rng.fold_in(key, 1)
                seed_sets.append(prepare_seeds(
                    fc, spx, spy, rng.fold_in(kr1, 2), memo=memo))
                ck = torch.zeros(R, k_max, 2, dtype=torch.int64, device=dev)
                for p in range(1, R + 1):
                    base = rng.fold_in(rng.fold_in(key, p), 4)
                    ck[p - 1, :fc.server_iters] = rng.split(
                        base, fc.server_iters)
                conv_keys.append(ck)
            plans.append(round_slot_plan(
                proto, ch, n_mod=model.num_params(params), n_labels=C,
                sample_bits=fc.sample_bits, n_seed=fc.n_seed, codec=spec))

        def tensor(vals, dtype):
            return torch.tensor(vals, dtype=dtype, device=dev)

        g_params = _stack_trees(inits)
        consts = {
            "key": torch.stack(run_keys),
            "eta": tensor([fc.eta for fc, _ in points], torch.float32),
            "beta": tensor([fc.beta for fc, _ in points], torch.float32),
            "s_iters": tensor([fc.server_iters for fc, _ in points],
                              torch.int64),
            "eps": tensor([fc.eps for fc, _ in points], torch.float64),
            "n_local": tensor(n_local, torch.int64),
            "p_up": tensor([pl["p_up"] for pl in plans], torch.float32),
            "p_dn": tensor([pl["p_dn"] for pl in plans], torch.float32),
        }
        if codec != "identity":
            # the codec's numbers are per point; sigma * clip multiplied
            # on the host, as the loop path multiplies its floats
            consts["levels"] = tensor([s.levels for s in specs],
                                      torch.float32)
            consts["noise"] = tensor([s.dp_sigma * s.dp_clip for s in specs],
                                     torch.float32)
            consts["clip"] = tensor([s.dp_clip for s in specs],
                                    torch.float32)

        # per-point link accounting and DP ledgers for the result frames
        self.up_bits_first = np.asarray([pl["up_bits_first"] for pl in plans],
                                        np.float64)
        self.up_bits_steady = np.asarray([pl["up_bits"] for pl in plans],
                                         np.float64)
        self.dp_epsilon = np.asarray(
            [gaussian_epsilon(s.dp_sigma, s.dp_delta, R)
             if s.name == "dp_gaussian" else np.nan for s in specs])
        self.dp_ledgers = []
        for (fc, _), s in zip(points, specs):
            if s.name != "dp_gaussian":
                self.dp_ledgers.append(None)
                continue
            acct = GaussianAccountant(s.dp_sigma, s.dp_delta,
                                      sample_ratio=fc.sample_ratio)
            for p in range(1, R + 1):
                acct.step(cohort=(fc.sampler.cohort(fc.seed, p, D)
                                  if sampled else None))
            self.dp_ledgers.append(acct.ledger())
        self.dp_epsilon_device = np.asarray(
            [led["epsilon_device_max"] if led else np.nan
             for led in self.dp_ledgers])

        if proto in FLD_FAMILY:
            sx, sy, n_train = _pad_seed_sets(seed_sets, C, dev)
            consts.update(seeds_x=sx, seeds_y=sy, n_train=n_train)
            conv = torch.stack(conv_keys, 1)              # (R, G, K_max, 2)
        else:
            consts.update(
                seeds_x=torch.zeros((G, 1) + feat, device=dev),
                seeds_y=torch.zeros(G, 1, dtype=torch.int64, device=dev),
                n_train=torch.ones(G, dtype=torch.int64, device=dev))
            conv = torch.zeros(R, G, 1, 2, dtype=torch.int64, device=dev)

        up1 = tensor([pl["up_slots_first"] for pl in plans], torch.int64)
        up = tensor([pl["up_slots"] for pl in plans], torch.int64)
        dn = tensor([pl["dn_slots"] for pl in plans], torch.int64)
        self.xs = []
        for p in range(1, R + 1):
            x = {"p": p, "up_slots": up1 if p == 1 else up,
                 "dn_slots": dn, "conv_keys": conv[p - 1]}
            if sampled:
                x["cohort"] = tensor(np.stack(
                    [fc.sampler.cohort(fc.seed, p, D) for fc, _ in points]),
                    torch.int64)
            self.xs.append(x)

        fns = {}
        if mesh is not None:
            shards = GridShards(mesh, G, Dc)
            fns = dict(local_train_fn=shards.local_train,
                       weighted_avg_fn=shards.weighted_avg,
                       gout_update_fn=shards.gout_update)
        self.step = make_grid_round_step(
            model, protocol=proto, num_devices=D, num_classes=C,
            local_iters=fc0.local_iters, local_batch=fc0.local_batch,
            server_batch=fc0.server_batch, t_max_slots=ch0.t_max_slots,
            tau_s=ch0.tau_s, dev_x=dev_x, dev_y=dev_y, data_rows=data_rows,
            test_x=test_x, test_y=test_y, consts=consts, codec=codec,
            cohort_size=Dc, arch_groups=arch_models, **fns)

        if arch_models is None:
            dev_params0 = _broadcast(g_params, D)
        else:
            dev_params0 = {
                a: _broadcast(g_params if a == arch_models[0][0] else
                              _stack_trees(arch_inits[a]), len(idx))
                for a, idx, _ in arch_models}
        n_params = model.num_params(inits[0])
        self.state0 = RoundState(
            dev_params=dev_params0, g_params=g_params,
            gout=torch.full((G, C, C), 1.0 / C, device=dev),
            dev_gout=torch.full((G, D, C, C), 1.0 / C, device=dev),
            prev=torch.zeros(G, C * C if proto == "fd" else n_params,
                             device=dev),
            converged_round=torch.zeros(G, dtype=torch.int64, device=dev),
            round=None, key=None, seeds=None, cum_time_s=None)
        self.program = GridRoundProgram(self.step, self.state0,
                                        options=options)
        self.seed_sets = seed_sets if proto in FLD_FAMILY else None

    @property
    def graphs(self) -> list:
        """The group's step graphs: its local step(s), then its
        conversion step."""
        gs = [g for at in self.step.local_trains for g in at.train.graphs]
        conv = self.step.conversion
        return gs + (conv.graphs if conv is not None else [])

    def start(self):
        """Queue the group's rounds (nothing is read back).  On a mesh,
        each rank computes the replicated steps: under cuDNN's
        deterministic algorithms, so the replicas stay equal."""
        self._built = len(self.graphs)
        with (deterministic_cudnn(self.state0.gout.device)
              if self.mesh is not None else contextlib.nullcontext()):
            self.program.step(self.state0, self.xs)

    def finish(self):
        """Wait for them: ``(state, {name: (R, G) array})``."""
        out = self.program.finalize()
        engine_stats.captures += len(self.graphs) - self._built
        return out


class SweepRunner:
    """One grid as one program per group; ``run()`` runs them again
    (warm runs build and capture nothing).  Partitioned grids take the
    flat sample pool as ``dev_x``/``dev_y`` and each point's
    :class:`PartitionSpec` splits it; grids with model or task axes pass
    ``model=None`` and build their models from the registry, a tasked
    grid its per-task pools (``task_data``, made by
    :func:`make_task_data` when not given).  ``device``: where the
    sweep runs, the GPU unless the caller asks for the CPU."""

    def __init__(self, model, grid: SweepGrid, dev_x=None, dev_y=None,
                 test_x=None, test_y=None, *, task_data=None,
                 options: Optional[ProgramOptions] = None, device=None):
        fc0, ch0 = grid.points[0]
        self.options = options or ProgramOptions()
        if ch0.num_devices != fc0.num_devices:
            raise ValueError(
                f"channel simulates {ch0.num_devices} links but the "
                f"population has {fc0.num_devices} devices")
        if model is not None and (
                grid.tasked
                or len({fc.model_key() for fc, _ in grid.points}) > 1
                or any(fc.model_partition is not None
                       for fc, _ in grid.points)):
            raise ValueError(
                "grids that sweep model/task axes (or run mixed-"
                "architecture cohorts) build their models from the "
                "registry; pass model=None")
        self.model = model
        self.grid = grid
        self.device = dev = resolve_device(device)
        if dev.type == "cuda":
            # full float32, as the loop's trainer
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        D, C = fc0.num_devices, fc0.num_classes

        if grid.tasked or task_data is not None:
            if dev_x is not None or dev_y is not None or \
                    test_x is not None or test_y is not None:
                raise ValueError(
                    "task-driven grids generate per-task pools and test "
                    "sets; pass dev_x/dev_y/test_x/test_y=None (supply "
                    "task_data=... to override the generated data)")
            if task_data is None:
                task_data = make_task_data(grid, device=dev)
            self.task_data = task_data
            parts = _resolve_task_partitions(grid, task_data)
        else:
            self.task_data = None
            parts = _resolve_partitions(grid, dev_x, dev_y, D, C)
        # each distinct partition on the device once (shared objects stay
        # shared: the seed memo and the stacking dedup by identity)
        moved: dict = {}

        def on_device(pair):
            if id(pair[0]) not in moved:
                moved[id(pair[0])] = (self._tensor(pair[0], torch.float32),
                                      self._tensor(pair[1], torch.int64))
            return moved[id(pair[0])]

        self.partitions = [on_device(pair) for pair in parts]
        # the 1-D device mesh of shard_devices grids (a group's mesh_shape
        # option, when given, takes its place)
        self.mesh = (make_device_mesh(D, fc0.mesh_shards or None, device=dev)
                     if fc0.shard_devices else None)

        memo = SeedPrepMemo()
        self._programs = []
        for (proto, codec, csize, modelk, task), idxs in \
                grid.program_groups().items():
            fcg = grid.points[idxs[0]][0]
            gmodel, arch_models = _group_models(model, fcg)
            tx, ty = (self.task_data[task][2:4]
                      if self.task_data is not None else (test_x, test_y))
            prog = _ProtocolProgram(
                gmodel, grid, proto, idxs,
                [self.partitions[i] for i in idxs],
                self._tensor(tx, torch.float32),
                self._tensor(ty, torch.int64), memo, dev, codec=codec,
                cohort_size=csize, arch_models=arch_models,
                options=self.options, mesh=self.mesh)
            self._programs.append((proto, idxs, prog))
        self.programs = len(self._programs)

        self.seed_memo = memo
        fld_pts = [g for g, (fc, _) in enumerate(grid.points)
                   if fc.protocol in FLD_FAMILY]
        self.seed_prep_stats = {
            "groups": len({grid.seed_key(g) for g in fld_pts}),
            "prep_runs": memo.misses,
            "memo_hits": memo.hits,
        }
        self.seed_sets = None
        if fld_pts:   # per point in grid order (None at fl/fd points)
            self.seed_sets = [None] * grid.size
            for _, idxs, prog in self._programs:
                if prog.seed_sets is not None:
                    for i, s in zip(idxs, prog.seed_sets):
                        self.seed_sets[i] = s

    def _tensor(self, a, dtype):
        if torch.is_tensor(a):
            return a.to(self.device, dtype)
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    @property
    def groups(self) -> list:
        """``(protocol, point indices, program)`` of each group."""
        return list(self._programs)

    def run(self) -> SweepResult:
        """Queue every group's rounds, then wait for each; the wall time
        covers both."""
        G, R = self.grid.size, self.grid.points[0][0].max_rounds
        acc = np.zeros((G, R), np.float32)
        loss = np.zeros((G, R), np.float32)
        latency = np.zeros((G, R), np.float64)
        up_ok = np.zeros((G, R), np.int32)
        converged = np.zeros((G,), np.int32)
        up_bits_first = np.zeros((G,), np.float64)
        up_bits = np.zeros((G,), np.float64)
        dp_epsilon = np.full((G,), np.nan)
        dp_epsilon_device = np.full((G,), np.nan)
        dp = [None] * G
        t0 = time.perf_counter()
        for _, _, prog in self._programs:
            prog.start()
        for _, idxs, prog in self._programs:
            state, out = prog.finish()
            rows = np.asarray(idxs)
            acc[rows] = out["acc"].T
            loss[rows] = out["loss"].T
            latency[rows] = out["latency_s"].T.astype(np.float64)
            up_ok[rows] = out["up_ok"].T
            converged[rows] = state.converged_round.cpu().numpy()
            up_bits_first[rows] = prog.up_bits_first
            up_bits[rows] = prog.up_bits_steady
            dp_epsilon[rows] = prog.dp_epsilon
            dp_epsilon_device[rows] = prog.dp_epsilon_device
            for i, led in zip(idxs, prog.dp_ledgers):
                dp[i] = led
        wall = time.perf_counter() - t0
        return SweepResult(
            grid=self.grid, acc=acc, loss=loss, latency_s=latency,
            up_ok=up_ok, converged=converged, wall_s=wall,
            up_bits_first=up_bits_first, up_bits=up_bits,
            dp_epsilon=dp_epsilon, dp_epsilon_device=dp_epsilon_device,
            dp=tuple(dp))


def run_sweep(model, grid: SweepGrid, dev_x=None, dev_y=None, test_x=None,
              test_y=None, *, task_data=None,
              options: Optional[ProgramOptions] = None,
              device=None) -> SweepResult:
    """Build a :class:`SweepRunner` and run it once."""
    return SweepRunner(model, grid, dev_x, dev_y, test_x, test_y,
                       task_data=task_data, options=options,
                       device=device).run()


def run_pointwise(model, grid: SweepGrid, dev_x=None, dev_y=None,
                  test_x=None, test_y=None, log=None, *, task_data=None,
                  device=None) -> list:
    """The per-point loop the sweep replaces, and its equivalence
    oracle: one ``FederatedTrainer.run`` per grid point, on the
    partitions, pools and models the runner would build."""
    fc0 = grid.points[0][0]
    if grid.tasked or task_data is not None:
        if task_data is None:
            task_data = make_task_data(grid, device=device)
        parts = _resolve_task_partitions(grid, task_data)
        tests = [task_data[fc.task][2:4] for fc, _ in grid.points]
    else:
        parts = _resolve_partitions(grid, dev_x, dev_y, fc0.num_devices,
                                    fc0.num_classes)
        tests = [(test_x, test_y)] * grid.size
    return [FederatedTrainer(model, fc, ch, device=device).run(
        px, py, tx, ty, log=log)
        for (fc, ch), (px, py), (tx, ty) in zip(grid.points, parts, tests)]
