#!/usr/bin/env python3
"""Device time of the eq. (5) conversion step for several checkouts of
the port, in turns, on one GPU.

    python3 tools/conversion_ab.py CHECKOUT [CHECKOUT ...] [--reps 5]

For each checkout (its ``src``), in a fresh process, in turns (the list,
then the list reversed), it builds two conversions of random CNN server
models on random seed sets (float32, digits shape, hard labels):

* ``loop``: one model, 200 seeds, batch 16, 160 steps (``chip_smoke.py``
  phase 3: Mix2FLD at the Sec. IV width), through the checkout's
  ``OutputToModel`` where it has one, else ``OutputToModelSteps`` with
  G = 1, as its ``FederatedTrainer`` converts;
* ``group``: four stacked models, 200 seeds each, batch 32, 150 steps
  (phase 18's conversion of a sweep group), through
  ``OutputToModelSteps`` where the checkout has it.

Each runs its steps once (the warm-up and the capture of its step
graph), then replays the captured step for all its steps under CUDA
events ``--reps`` times (median device ms a step) and once under
``torch.profiler`` (device operations a step and busy ms a step).  Each
child prints one JSON line; the parent prints each turn and, last, the
median of the turns for every checkout.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

from round_ab import busy_ms


def _time(graph, steps: int, reps: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(reps):
        graph.counter.zero_()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            graph.graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / steps)
    graph.counter.zero_()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            graph.graph.replay()
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages()
              if e.self_device_time_total > 0)
    return {"ms": statistics.median(times), "ms_all": times,
            "ops": ops / steps, "busy_ms": busy_ms(prof) / steps}


def child(src: str, reps: int) -> None:
    sys.path.insert(0, src)
    import torch

    from repro_torch import rng
    from repro_torch.core import conversion
    from repro_torch.models import CNN

    if not torch.cuda.is_available():
        raise SystemExit("conversion_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    # the trainer's settings: full float32 convolutions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cnn = CNN()
    gen = torch.Generator().manual_seed(0)

    def seeds(g, n):
        x = torch.rand((g, n, 28, 28, 1), generator=gen).to(dev)
        y = torch.randint(0, 10, (g, n), generator=gen).to(dev)
        gout = torch.softmax(torch.randn(g, 10, 10, generator=gen), -1)
        return x, y, gout.to(dev)

    def stacked(g):
        inits = [cnn.init(rng.PRNGKey(1 + i, dev)) for i in range(g)]
        return {k: {m: torch.stack([p[k][m] for p in inits]) for m in v}
                for k, v in inits[0].items()}

    def steps_call(g, n, batch, k):
        x, y, gout = seeds(g, n)
        keys = rng.split(rng.split(rng.PRNGKey(5, dev), g), k)
        conv = conversion.OutputToModelSteps(cnn.apply)
        conv(stacked(g), x, y, gout, keys,
             torch.full((g,), k, dtype=torch.int64, device=dev), n, batch,
             torch.full((g,), 0.01, device=dev),
             torch.full((g,), 0.01, device=dev))
        return conv

    out = {"device": torch.cuda.get_device_name(0)}
    if hasattr(conversion, "OutputToModel"):
        x, y, gout = seeds(1, 200)
        conv = conversion.OutputToModel(cnn.apply)
        conv(cnn.init(rng.PRNGKey(1, dev)), x[0], y[0], gout[0], 160, 16,
             0.01, 0.01, rng.PRNGKey(5, dev))
        out["loop_class"] = "OutputToModel"
    else:
        conv = steps_call(1, 200, 16, 160)
        out["loop_class"] = "OutputToModelSteps, G = 1"
    out["loop"] = _time(conv.graphs[0], 160, reps)
    if hasattr(conversion, "OutputToModelSteps"):
        out["group"] = _time(steps_call(4, 200, 32, 150).graphs[0], 150,
                             reps)
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs="*")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.reps)
        return 0
    if not args.checkouts:
        ap.error("give one or more checkouts' directories")
    trees = [str(Path(c).resolve() / "src") for c in args.checkouts]
    res = {t: [] for t in trees}
    for tree in trees + trees[::-1]:
        out = subprocess.run(
            [sys.executable, __file__, "--child", tree, "--reps",
             str(args.reps)], capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        r = json.loads(out.stdout.strip().splitlines()[-1])
        res[tree].append(r)
        print(f"{tree}, {r['device']}: " + "; ".join(
            f"{name} {r[name]['ms']:.6f} ms a step "
            f"({r[name]['ops']:.2f} device operations, busy "
            f"{r[name]['busy_ms']:.6f} ms)"
            for name in ("loop", "group") if name in r)
            + f" [loop: {r['loop_class']}]", flush=True)
    print(json.dumps({"median_of_turns": {
        tree: {name: statistics.median(r[name]["ms"] for r in rs)
               for name in ("loop", "group") if name in rs[0]}
        for tree, rs in res.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
