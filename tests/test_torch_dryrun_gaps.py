"""The dry run's bridges of DTensor's gaps (``launch/dryrun.py``
``ShardingGaps`` and ``_mem_tracker``), on this torch made to refuse
what torch 2.11 refuses.

The card machine runs torch 2.11; the gaps below are 2.11's, emulated
on the release installed here by taking an op's strategy out of
DTensor's sharding propagator, by raising where 2.11's propagation or
redistribution raises, or by making the MemTracker count what 2.11's
counts (:func:`emulate`):

* ``roll``: ``aten.roll`` has no strategy (the window prefill's ring
  cache);
* ``shard_to_partial``: a redistribution of a split operand to a partial
  sum raises, and a residual add that mixes a partial sum with a split
  operand asks for one, as 2.11's pointwise strategy does in the MoE
  decode (this release reduces the partial sum instead, so the add is
  made to raise as 2.11's redistribution does);
* ``flatten``: a view that merges a split dim into the dim before it
  (the residual's rows flattened for the unembedding) is refused;
* ``hybrid_index``: an index whose dim two mesh dims split (the tokens
  over ("pod", "data")) fails its strategy;
* ``memtracker``: the MemTracker counts the fake tensors of DTensor's
  own propagation (2.11's MemTracker does; the whole (B, S, V) logits of
  a prefill, 297 GiB a rank at qwen2-0.5b's prefill_32k).

Every record runs in a process of its own (a fake world of 512 ranks,
never this process's group); the values run on a real world of four
gloo ranks (``launch/ranks.py::spawn_ranks``), every emulation on,
against the plain, unsharded steps.  The 2.11 refusals themselves are
checked on the card by ``chip_smoke.py`` phase 48.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EMULATIONS = ("roll", "shard_to_partial", "flatten", "hybrid_index",
              "memtracker")


# ---------------------------------------------------------------------------
# torch 2.11's refusals, on the installed release
# ---------------------------------------------------------------------------

def _propagator():
    from torch.distributed.tensor import DTensor
    return DTensor._op_dispatcher.sharding_propagator


def _refuse_strategy(op) -> None:
    """``op`` without a strategy, its cached propagations dropped."""
    sp = _propagator()
    for table in (sp.op_strategy_funcs, sp.op_to_rules,
                  getattr(sp, "op_single_dim_strategy_funcs", {})):
        table.pop(op, None)
    sp.propagate_op_sharding.cache_clear()


def _refuse_in_propagation(check) -> None:
    """``check(op_schema)`` before every propagation: it raises where
    2.11's does."""
    from torch.distributed.tensor._sharding_prop import LocalLRUCache
    sp = _propagator()
    inner = sp.propagate_op_sharding_non_cached

    def propagate(op_schema):
        check(op_schema)
        return inner(op_schema)

    sp.propagate_op_sharding_non_cached = propagate
    sp.propagate_op_sharding = LocalLRUCache(propagate)


def _specs(op_schema) -> list:
    out = []
    for a in op_schema.args_schema:
        out += [b for b in (a if isinstance(a, (list, tuple)) else [a])
                if hasattr(b, "placements")]
    return out


def _add_mixing_partial_and_shard(op_schema) -> None:
    from torch.distributed.tensor import Shard
    if op_schema.op is not torch.ops.aten.add.Tensor:
        return
    specs = _specs(op_schema)
    for j in range(specs[0].mesh.ndim):
        pl = [s.placements[j] for s in specs]
        shard = next((p for p in pl if isinstance(p, Shard)), None)
        if shard is not None and any(p.is_partial() for p in pl):
            raise RuntimeError(f"redistribute from {shard} to P(sum) not "
                               "supported yet")


def _hybrid_index(op_schema) -> None:
    from torch.distributed.tensor import Shard
    if op_schema.op is not torch.ops.aten.index.Tensor:
        return
    for spec in _specs(op_schema)[1:]:
        dims = [p.dim for p in spec.placements if isinstance(p, Shard)]
        if len(dims) != len(set(dims)):
            raise RuntimeError(
                "Sharding propagation failed: DTensor operator "
                "implementation does not support things like hybrid "
                "sharding strategies yet (i.e. [Shard(0), Shard(0)])")


def _merged_groups(src, dst) -> list:
    """The groups of ``src``'s dims that a view to ``dst`` merges into
    one dim (each a list of two or more dims)."""
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        group, n = [i], src[i]
        while n < dst[j] and i + 1 < len(src):
            i += 1
            group.append(i)
            n *= src[i]
        if n == dst[j] and len(group) > 1:
            groups.append(group)
        i, j = i + 1, j + 1
    return groups


def _flatten_of_a_split_dim(op_schema) -> None:
    from torch.distributed.tensor import Shard
    if op_schema.op not in (torch.ops.aten.view.default,
                            torch.ops.aten._unsafe_view.default):
        return
    spec, size = op_schema.args_schema[0], op_schema.args_schema[1]
    split = {p.dim for p in spec.placements if isinstance(p, Shard)}
    for group in _merged_groups(tuple(spec.shape), tuple(size)):
        if split & set(group[1:]):
            raise RuntimeError(
                "('Attempted to flatten multiple dimensions, with dimension "
                f"{min(split & set(group[1:]))} being sharded. ', 'It cannot "
                "be performed without redistribution, which is disallowed "
                "by the current operator.')")


def _refuse_shard_to_partial() -> None:
    import torch.distributed.tensor._api as api
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute
    inner = redistribute.redistribute_local_tensor

    def refusing(local_tensor, current_spec, target_spec, **kw):
        for cur, tgt in zip(current_spec.placements, target_spec.placements):
            if not cur.is_partial() and not cur.is_replicate() and \
                    tgt.is_partial():
                raise RuntimeError(f"redistribute from {cur} to {tgt} not "
                                   "supported yet")
        return inner(local_tensor, current_spec, target_spec, **kw)

    for mod in (redistribute, dispatch, api):
        mod.redistribute_local_tensor = refusing


def _count_fake_tensors() -> None:
    import torch.distributed._tools.mem_tracker as mem_tracker
    mem_tracker.active_fake_mode = lambda: None


def emulate(*names) -> None:
    """Make this process's torch refuse what 2.11 refuses (the names of
    :data:`EMULATIONS`)."""
    for name in names:
        if name == "roll":
            _refuse_strategy(torch.ops.aten.roll.default)
        elif name == "shard_to_partial":
            _refuse_shard_to_partial()
            _refuse_in_propagation(_add_mixing_partial_and_shard)
        elif name == "flatten":
            _refuse_in_propagation(_flatten_of_a_split_dim)
        elif name == "hybrid_index":
            _refuse_in_propagation(_hybrid_index)
        elif name == "memtracker":
            _count_fake_tensors()
        else:
            raise ValueError(name)


# ---------------------------------------------------------------------------
# Records in processes of their own
# ---------------------------------------------------------------------------

_RECORDS = """
    import dataclasses, json, sys
    from test_torch_dryrun_gaps import emulate
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    out = []
    for names, arch, shape, widths in json.loads(sys.argv[1]):
        emulate(*names)
        cfg = dataclasses.replace(get_config(arch).smoke(), **widths)
        rec = dryrun.dry_run_combo(arch, shape, False, save=False,
                                   verbose=False, cfg=cfg)
        out.append({k: rec.get(k) for k in ("status", "error", "reshards",
                                            "memory", "dominant")})
    print(json.dumps(out))
    """

_TRACKER = """
    import json, torch
    from test_torch_dryrun_gaps import emulate
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch import dryrun
    dryrun.start_fake_world()
    mesh = dryrun.make_production_mesh(device="cpu")
    out = []
    for names, width in (([], 64), (["memtracker"], 32)):
        emulate(*names)   # a new shape: DTensor keeps what it propagated
        x = DTensor.from_local(torch.empty(4, 64, width, device="meta"),
                               mesh, (Shard(0), Shard(1)), run_check=False)
        for mt in (MemTracker(), dryrun._mem_tracker()):
            with mt:
                x.view(64, 1024 * width)
            out.append(dryrun._peak(mt))
    print(json.dumps(out))
    """


def _records(*runs) -> tuple:
    """The process of each ``(emulations, arch, shape[, widths])`` of
    ``runs``, in order, at smoke widths (``widths`` replacing some) on
    16 x 16 (an emulation stays on for the runs after it: DTensor keeps
    what it propagated before)."""
    return _RECORDS, json.dumps([r if len(r) == 4 else r + ({},)
                                 for r in runs])


# every process of the file's records, started at once (a process a
# record or an emulation: DTensor's propagation caches outlive a change
# of its strategies)
_JOBS = {
    "refused": _records((["roll"], "h2o-danube-3-4b", "prefill_32k"),
                        ([], "zamba2-2.7b", "prefill_32k"),
                        (["shard_to_partial"], "qwen2-moe-a2.7b",
                         "decode_32k")),
    "plain": _records(([], "qwen2-0.5b", "prefill_32k"),
                      # qwen2-0.5b's vocabulary and buckets
                      ([], "qwen2-0.5b", "train_4k",
                       {"vocab_size": 151936, "fd_buckets": 256})),
    "prefill-refused": _records(
        (["flatten"], "qwen2-0.5b", "prefill_32k"),
        (["memtracker"], "qwen2-0.5b", "prefill_32k")),
    "tracker": (_TRACKER,),
}


class _Processes:
    """``_JOBS`` in processes of their own (one intra-op thread each,
    this file importable), all started at once; :meth:`__getitem__`
    waits for one and returns the JSON of its last line."""

    def __init__(self, jobs: dict):
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep
                   .join([str(ROOT / "src"), str(ROOT / "tests")]))
        self.procs = {
            name: subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(code), *args],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=ROOT)
            for name, (code, *args) in jobs.items()}
        self.out = {}

    def __getitem__(self, name):
        if name not in self.out:
            out, err = self.procs[name].communicate(timeout=300)
            assert self.procs[name].returncode == 0, out[-3000:] + err[-3000:]
            self.out[name] = json.loads(out.strip().splitlines()[-1])
        return self.out[name]

    def stop(self):
        for name, proc in self.procs.items():
            if name not in self.out:   # unread: stop it, close its pipes
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def jobs(four_ranks_started):
    procs = _Processes(_JOBS)
    yield procs
    procs.stop()


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "zamba2-2.7b"])
def test_window_prefill_needs_no_roll_strategy(jobs, arch):
    """The sliding-window prefill's ring cache takes no ``aten.roll``:
    with its strategy gone the record is ``ok``."""
    rec = jobs["refused"][["h2o-danube-3-4b", "zamba2-2.7b"].index(arch)]
    assert rec["status"] == "ok", rec["error"]


@pytest.mark.parametrize("S, Sc", [(10, 4), (12, 4), (7, 7), (5, 8),
                                   (160, 128), (4097, 4096), (9, 2)])
def test_ring_cache_equals_the_reference_roll(S, Sc):
    """``_tail_cache`` (two slices, no roll) equals the reference's
    ``jnp.roll`` ring cache element for element."""
    from repro_torch.models.attention import _tail_cache
    from test_torch_reference import load_reference
    k = np.random.default_rng(S * 31 + Sc).standard_normal(
        (2, S, 3, 4)).astype(np.float32)
    want = np.asarray(load_reference().attention._tail_cache(k, Sc))
    got = _tail_cache(torch.from_numpy(k), Sc).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_moe_decode_with_shard_to_partial_refused(jobs):
    """qwen2-moe's decode under ``decode_tp``: with the redistribution of
    a split operand to a partial sum refused, the residual add sums the
    partial operand into the split first; the record is ``ok``."""
    rec = jobs["refused"][2]
    assert rec["status"] == "ok", rec["error"]
    assert rec["reshards"].get("add of a sharded dim", 0) > 0


def test_refused_flatten_keeps_the_peak(jobs):
    """qwen2-0.5b's smoke prefill_32k with the flatten of the residual's
    split rows refused (the logits path's view): the same argument bytes,
    the peak within 10% and the same dominant term."""
    (plain, _), (refused, _) = jobs["plain"], jobs["prefill-refused"]
    assert [plain["status"], refused["status"]] == ["ok", "ok"], \
        (plain["error"], refused["error"])
    assert refused["reshards"].get("view of a sharded dim", 0) > \
        plain["reshards"].get("view of a sharded dim", 0)
    assert refused["memory"]["argument_bytes"] == \
        plain["memory"]["argument_bytes"]
    ratio = (refused["memory"]["memtracker_peak_bytes"]
             / plain["memory"]["memtracker_peak_bytes"])
    assert 0.9 <= ratio <= 1.1, ratio
    assert refused["dominant"] == plain["dominant"]


def test_peak_counts_no_fake_tensor_of_the_propagation(jobs):
    """With the MemTracker counting DTensor's fake tensors as 2.11's
    does, the dry run's tracker still counts the local blocks alone."""
    refused, counted = jobs["prefill-refused"]
    assert counted["status"] == "ok", counted["error"]
    assert counted["memory"] == refused["memory"]


def test_tracker_emulation_counts_the_fake_tensors(jobs):
    """The emulation is 2.11's count: the MemTracker itself, entered
    bare around a view of a DTensor, counts a tensor of the view's
    global shape only with the emulation on; the dry run's does not."""
    bare, ours, bare_211, ours_211 = jobs["tracker"]
    assert bare == ours == 4 * 64 * 64 * 4    # rank 0's block
    assert bare_211 >= 64 * 1024 * 32 * 4     # the view's global shape
    assert ours_211 == 4 * 64 * 32 * 4


def test_train_step_holds_no_whole_logits(jobs):
    """The smoke train step at qwen2-0.5b's vocabulary and buckets (151,936
    tokens padded to 256 x 594): no pad, gather gradient or log-sum-exp
    on any rank holds a chunk's (256, 512, 151936) float32 logits whole
    (79.7 GB; the parent tree's peak was 324.7 GB, this tree's 16.2 GB)."""
    got = jobs["plain"][1]
    assert got["status"] == "ok", got["error"]
    assert got["memory"]["memtracker_peak_bytes"] < 256 * 512 * 151936 * 4
    assert got["reshards"].get("constant_pad_nd of a sharded dim", 0) > 0
    assert got["reshards"].get("new_zeros split as its input", 0) > 0


# ---------------------------------------------------------------------------
# Values on four gloo ranks
# ---------------------------------------------------------------------------

def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _max_diff(a, b) -> float:
    if isinstance(a, dict):
        return max((_max_diff(a[k], b[k]) for k in a), default=0.0)
    if not torch.is_tensor(b):
        return 0.0 if a == b else float("inf")
    return (_full(a).double() - b.double()).abs().max().item()


def _snapshot(tree):
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    return _full(tree).clone() if torch.is_tensor(tree) else tree


def _prefill_and_decode(cfg, mesh, B=4, S=160, decode=True) -> dict:
    """Greedy prefill of ``S`` tokens and (``decode``) one decode step,
    plain and on ``mesh`` by the rules: the largest differences of the
    logits and caches, and the gaps the sharded steps bridged (the cache
    made as each rank's blocks, ``dryrun.placed_zeros``)."""
    import functools
    from repro_torch import rng
    from repro_torch.data import synthetic_tokens
    from repro_torch.launch import dryrun, sharding as shp, steps
    from repro_torch.models import kvcache
    from repro_torch.models.shardhooks import set_activation_sharding
    from repro_torch.models.transformer import forward, init_params
    total = S + 2
    params = init_params(cfg, rng.PRNGKey(0), device="cpu")
    tokens = synthetic_tokens(rng.PRNGKey(1), B, S, cfg.vocab_size,
                              device="cpu")
    with torch.no_grad():
        lg0, c0 = steps.make_prefill_step(cfg, total)(params,
                                                      {"tokens": tokens})
        prefill_cache0 = _snapshot(c0)
        nxt = lg0.argmax(-1)[:, None]
        if decode:
            dlg0, _, c0 = forward(cfg, params, {"tokens": nxt}, cache=c0)
    decode_tp = shp.use_decode_tp(cfg, mesh, params)
    placed = dryrun.place(mesh, params, shp.param_pspecs(
        cfg, mesh, params, decode_tp=decode_tp))
    c_specs = shp.batch_pspecs(cfg, mesh, {"cache": kvcache.cache_specs(
        cfg, B, total)})["cache"]
    prefill = dryrun.sharded_step(steps.make_prefill_step(
        cfg, total, init_cache=functools.partial(
            dryrun.placed_zeros(mesh, c_specs), cfg)))
    decode_step = dryrun.sharded_step(lambda p, b: forward(
        cfg, p, {"tokens": b["tokens"]}, cache=b["cache"]))
    set_activation_sharding(shp.sharding_hook(cfg, mesh))
    try:
        with torch.no_grad():
            batch = {"tokens": tokens}
            lg1, c1 = prefill(placed, dryrun.place(
                mesh, batch, shp.batch_pspecs(cfg, mesh, batch)))
            out = {"prefill_logits": _max_diff(lg1, lg0),
                   "prefill_cache": _max_diff(c1, prefill_cache0),
                   "gaps": dict(prefill.gaps.counts)}
            if not decode:
                return out
            batch = {"tokens": nxt}
            batch = dict(dryrun.place(mesh, batch,
                                      shp.batch_pspecs(cfg, mesh, batch)),
                         cache=c1)
            dlg1, _, c1 = decode_step(placed, batch)
    finally:
        set_activation_sharding(None)
    out.update(decode_logits=_max_diff(dlg1[:, -1], dlg0[:, -1]),
               decode_cache=_max_diff(c1, c0),
               gaps=dict(prefill.gaps.counts + decode_step.gaps.counts))
    return out


def _train_loss_and_grads(cfg, mesh, B=4, S=1024) -> dict:
    """The chunked LM loss (CE + KD, the vocabulary padded for the
    buckets) and its gradients, plain and on ``mesh``."""
    import functools
    from repro_torch import rng
    from repro_torch.data import synthetic_tokens
    from repro_torch.launch import dryrun, sharding as shp, steps
    from repro_torch.models.shardhooks import set_activation_sharding
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, rng.PRNGKey(0), device="cpu")
    gout = torch.softmax(torch.from_numpy(np.random.default_rng(2)
                         .standard_normal((cfg.fd_buckets,) * 2)
                         .astype(np.float32)), -1)
    batch = {"tokens": synthetic_tokens(rng.PRNGKey(1), B, S,
                                        cfg.vocab_size, device="cpu"),
             "gout": gout}
    loss_fn = functools.partial(steps._lm_loss, cfg)
    (loss0, _), g0 = steps.value_and_grad(loss_fn, params, batch)
    step = dryrun.sharded_step(
        lambda p, b: steps.value_and_grad(loss_fn, p, b))
    set_activation_sharding(shp.sharding_hook(cfg, mesh))
    try:
        (loss1, _), g1 = step(
            dryrun.place(mesh, params, shp.param_pspecs(cfg, mesh, params)),
            dryrun.place(mesh, batch, shp.batch_pspecs(cfg, mesh, batch)))
    finally:
        set_activation_sharding(None)
    return {"loss": _max_diff(loss1, loss0), "grads": _max_diff(g1, g0),
            "gaps": dict(step.gaps.counts)}


def _ranks_fn(rank, world):
    """Every emulation on; the window prefill, the MoE decode and the
    padded loss on a (2, 2) ("data", "model") mesh, and the embedding
    lookup of a prefill on a (2, 2, 1) ("pod", "data", "model") one."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    def smoke(arch, **kw):   # one layer of the smoke config
        return dataclasses.replace(get_config(arch).smoke(), num_layers=1,
                                   **kw)

    emulate(*EMULATIONS)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {arch: _prefill_and_decode(smoke(arch), mesh)
           for arch in ("h2o-danube-3-4b", "qwen2-moe-a2.7b")}
    out["train"] = _train_loss_and_grads(smoke("qwen2-0.5b",
                                               vocab_size=505), mesh)
    pods = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    out["pods"] = _prefill_and_decode(smoke("qwen2-0.5b"), pods,
                                      decode=False)
    return out


@pytest.fixture(scope="module")
def four_ranks_started(tmp_path_factory):
    """The four ranks, started (in the background) before the records'
    processes."""
    from repro_torch.launch.ranks import spawn_ranks
    return spawn_ranks(_ranks_fn, 4, tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def four_ranks(four_ranks_started, jobs):
    return four_ranks_started.results()


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "qwen2-moe-a2.7b",
                                  "pods"])
def test_bridged_serve_equals_the_plain_serve(four_ranks, arch):
    """The bridged window prefill and decode (its 128-slot ring cache
    over 160 tokens), the bridged MoE prefill and decode, and the prefill
    on ("pod", "data", "model") whose embedding lookup the index bridge
    takes: logits and caches within 1e-5 of the plain steps on every
    rank."""
    for rank, out in enumerate(four_ranks):
        got = out[arch]
        keys = ("prefill_logits", "prefill_cache") + (
            () if arch == "pods" else ("decode_logits", "decode_cache"))
        for key in keys:
            assert got[key] <= 1e-5, (rank, key, got[key])
    gaps = four_ranks[0][arch]["gaps"]
    if arch == "qwen2-moe-a2.7b":
        assert gaps.get("add of a sharded dim", 0) > 0, gaps
    if arch == "pods":
        assert gaps.get("index of a sharded dim", 0) > 0, gaps


def test_bridged_loss_equals_the_plain_loss(four_ranks):
    """The padded buckets' pad and the gather's gradient zeros, bridged:
    the loss and every gradient within 1e-5 of the plain ones."""
    for rank, out in enumerate(four_ranks):
        got = out["train"]
        assert got["loss"] <= 1e-5 and got["grads"] <= 1e-5, (rank, got)
    gaps = four_ranks[0]["train"]["gaps"]
    assert gaps.get("constant_pad_nd of a sharded dim", 0) > 0, gaps
    assert gaps.get("new_zeros split as its input", 0) > 0, gaps
