#!/usr/bin/env python3
"""Every (arch x shape) record of the dry run on one production mesh, at a
cut depth, in parallel processes on the CPU, and a summary of them.

    PYTHONPATH=src python3 tools/dryrun_all.py [--multi-pod] [--layers 1]
        [--jobs 8] [--out DIR] [--archs A,B] [--shapes S,T]

Each process (one intra-op thread, CUDA hidden) takes the next
(arch, shape) of ``--all``'s list and runs ``dryrun.dry_run_combo`` with
the arch's config cut to ``--layers`` layers (a hybrid's to that many
super-blocks of ``attn_every`` layers; 0: the published depth), its
record under ``--out`` (default ``build/dryrun_all/``).  The parent
prints one line a record (status, run s, per-rank peak and argument
bytes, collective bytes, dominant term, reshards), then the count of
each status and the wall time, and exits 1 if any record is an
``error``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cut(cfg, layers: int):
    """``cfg`` at ``layers`` layers (a hybrid's: super-blocks)."""
    if not layers:
        return cfg
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=layers * cfg.attn_every)
    return dataclasses.replace(cfg, num_layers=layers)


def one(job):
    arch, shape, multi_pod, layers, out = job
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    rec = dryrun.dry_run_combo(arch, shape, multi_pod, verbose=False,
                               cfg=cut(get_config(arch), layers),
                               out_dir=out)
    return {k: rec.get(k) for k in ("arch", "shape", "mesh", "status",
                                    "run_s", "memory", "reshards",
                                    "collective_bytes_per_device",
                                    "dominant", "error")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out", default=str(ROOT / "build" / "dryrun_all"))
    ap.add_argument("--archs", default=None)
    ap.add_argument("--shapes", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import INPUT_SHAPES, list_archs
    archs = (args.archs.split(",") if args.archs
             else list_archs(assigned_only=True))
    shapes = args.shapes.split(",") if args.shapes else list(INPUT_SHAPES)
    jobs = [(a, s, args.multi_pod, args.layers, args.out)
            for a in archs for s in shapes]
    t0 = time.time()
    statuses = Counter()
    with ProcessPoolExecutor(args.jobs) as pool:
        for rec in pool.map(one, jobs):
            statuses[rec["status"]] += 1
            mem = rec.get("memory") or {}
            print(json.dumps({
                "record": f"{rec['arch']} {rec['shape']} {rec['mesh']}",
                "status": rec["status"], "run_s": rec.get("run_s"),
                "peak": mem.get("memtracker_peak_bytes"),
                "args": mem.get("argument_bytes"),
                "coll": rec.get("collective_bytes_per_device"),
                "dominant": rec.get("dominant"),
                "reshards": rec.get("reshards"),
                "error": (rec.get("error") or "")[:300] or None}),
                flush=True)
    print(json.dumps({"statuses": dict(statuses), "records": len(jobs),
                      "layers": args.layers, "multi_pod": args.multi_pod,
                      "wall_s": round(time.time() - t0, 1)}))
    return 1 if statuses["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
