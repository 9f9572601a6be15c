#!/usr/bin/env python3
"""What one dry-run record is made of: the storages rank 0 holds at its
MemTracker peak, its collective bytes by the op that issued them, and
the redistribution plans DTensor made for it.

    PYTHONPATH=src python3 tools/dryrun_anatomy.py --arch qwen2-0.5b \\
        --shape train_4k [--multi-pod] [--layers N] [--top 12]

``--shape`` takes ``fl_sync`` or ``fd_sync`` too.  Runs the record as
``python -m repro_torch.launch.dryrun`` does (CUDA hidden, one thread)
and prints one JSON object: the record's status, peak and collective
bytes; ``peak``: the ``--top`` largest storages alive at the peak, each
with the op that made it, its shape and MemTracker's reference type;
``collectives``: bytes by (the outermost op of the step that issued
them, kind); ``plans``: the count and seconds of DTensor's
redistribution plans, by planner (``graph``: the graph search taken for
any ``_StridedShard`` or non-default shard order; ``greedy``).  Reads a
checkout's own ``src`` (run it with that checkout's ``PYTHONPATH``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from collections import Counter


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: all)")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch
    import torch.distributed.tensor._redistribute as redistribute
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils.weak import WeakIdKeyDictionary
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)

    made, peak = WeakIdKeyDictionary(), {"bytes": 0, "live": []}
    tracker = dryrun._mem_tracker

    def traced_tracker():
        mt = tracker()
        cls = type(mt)
        dispatch, track, update = (cls.__torch_dispatch__, cls._track,
                                   cls._update_peak_stats)

        def on_dispatch(self, func, types, a=(), kw=None):
            self._op = func._schema.name
            return dispatch(self, func, types, a, kw)

        def on_track(self, reftype, t):
            st = t.untyped_storage()
            if st not in made:
                made[st] = (getattr(self, "_op", "?"), list(t.shape),
                            str(reftype).rpartition(".")[2])
            return track(self, reftype, t)

        def on_update(self, state):
            now = max((s.get("Total", 0) for s in
                       self._curr_mem_snap.values()), default=0)
            if now > peak["bytes"]:
                peak["bytes"] = now
                live = [(st.nbytes(),) + made.get(st, ("?", [], "?"))
                        for st in list(self._WINFO.keys())]
                peak["live"] = sorted(live, key=lambda r: -r[0])[:args.top]
            return update(self, state)

        cls.__torch_dispatch__ = on_dispatch
        cls._track = on_track
        cls._update_peak_stats = on_update
        return mt

    dryrun._mem_tracker = traced_tracker

    ops, by_op = [], Counter()
    gaps_dispatch = dryrun.ShardingGaps.__torch_dispatch__
    rec_dispatch = dryrun.CollectiveRecorder.__torch_dispatch__

    def on_gap(self, func, types, a=(), kw=None):
        ops.append(func._schema.name.partition("::")[2])
        try:
            return gaps_dispatch(self, func, types, a, kw)
        finally:
            ops.pop()

    def on_collective(self, func, types, a=(), kw=None):
        n = len(self.records)
        out = rec_dispatch(self, func, types, a, kw)
        for kind, nbytes, _ in self.records[n:]:
            by_op[(ops[0] if ops else "(the step)", kind)] += nbytes
        return out

    dryrun.ShardingGaps.__torch_dispatch__ = on_gap
    dryrun.CollectiveRecorder.__torch_dispatch__ = on_collective

    plans = {"graph": [0, 0.0], "greedy": [0, 0.0]}
    planner = redistribute._gen_transform_infos_non_cached

    def on_plan(src, dst, *a, **kw):
        t0 = time.perf_counter()
        out = planner(src, dst, *a, **kw)
        graph = any(isinstance(p, _StridedShard)
                    for p in (*src.placements, *dst.placements)) or not all(
            src.is_default_device_order(o)
            for o in (src.shard_order, dst.shard_order))
        entry = plans["graph" if graph else "greedy"]
        entry[0] += 1
        entry[1] += time.perf_counter() - t0
        return out

    redistribute._gen_transform_infos_non_cached = on_plan

    cfg = get_config(args.arch)
    if args.layers:
        n = args.layers * (cfg.attn_every if cfg.family == "hybrid" else 1)
        cfg = dataclasses.replace(cfg, num_layers=n)
    t0 = time.time()
    if args.shape in ("fl_sync", "fd_sync"):
        recs = dryrun.dry_run_sync_steps(args.arch, save=False, cfg=cfg)
        rec = next(r for r in recs if r["shape"] == args.shape)
    else:
        rec = dryrun.dry_run_combo(args.arch, args.shape, args.multi_pod,
                                   save=False, verbose=False, cfg=cfg)
    mem = rec.get("memory", {})
    print(json.dumps({
        "record": f"{args.arch} {args.shape}", "torch": torch.__version__,
        "status": rec["status"], "error": rec.get("error"),
        "wall_s": round(time.time() - t0, 1),
        "peak_bytes": mem.get("memtracker_peak_bytes",
                              rec.get("memtracker_peak_bytes")),
        "collective_bytes": rec.get("collective_bytes_per_device"),
        "reshards": rec.get("reshards"),
        "peak": [{"bytes": b, "op": op, "shape": shape, "ref": ref}
                 for b, op, shape, ref in peak["live"]],
        "collectives": [[op, kind, b] for (op, kind), b in
                        by_op.most_common(args.top)],
        "plans": {k: {"count": n, "s": round(s, 1)}
                  for k, (n, s) in plans.items()}}))
    return 0 if rec["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
