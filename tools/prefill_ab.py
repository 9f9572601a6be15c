#!/usr/bin/env python3
"""Warm serve-prefill time of two checkouts of the port, in turns, on one GPU.

    python3 tools/prefill_ab.py OTHER_CHECKOUT [--arch qwen2-0.5b] [--reps 20]

Times the prefill step of ``repro_torch`` at an architecture's full config
(batch 4, prompt 1024, room for 32 generated tokens; random weights from
PRNGKey(0), prompts from PRNGKey(1), as ``chip_smoke.py`` phase 7 serves
them), once from OTHER_CHECKOUT/src and once from this checkout's src,
each in a fresh process, in turns: other, this, this, other.  A turn
builds its checkout's kernels into that checkout's build/ directory,
makes two untimed calls, then times ``reps`` calls (host clock around the
call, ending in ``torch.cuda.synchronize()``).  Prints each turn's median
and, per checkout, the median over all its calls and the difference.
Each turn then traces five more calls with ``torch.profiler`` and prints
the device's busy time per call (the sum of its kernels' device time)
and the kernels that take the most, then the port's own kernels (the
hand-written CUDA ones) with their share.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

THIS = Path(__file__).resolve().parents[1]
BATCH, PROMPT, GEN = 4, 1024, 32
# the kernels of src/repro_torch/csrc that a prefill launches, by name
PORT_KERNELS = re.compile(r"flash_fwd|ssd_scan_kernel|chunk_states|"
                          r"state_pass|chunk_scan")


def short(kernel: str) -> str:
    """A kernel's name without return type, namespace and arguments."""
    return (kernel.removeprefix("void ")
            .replace("(anonymous namespace)::", "").split("(")[0])


def device_busy(step, args, calls=5):
    """Device time of ``calls`` traced calls of ``step``: (busy ms per
    call, [(kernel, ms per call), ...] largest first); None if the trace
    holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step(*args)
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3 / calls)
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    if not kernels:
        return None
    kernels.sort(key=lambda kv: -kv[1])
    return sum(ms for _, ms in kernels), kernels


def child(src: str, arch: str, reps: int) -> None:
    sys.path.insert(0, src)
    import torch

    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_tokens
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import init_params

    if not torch.cuda.is_available():
        raise SystemExit("prefill_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # as launch/serve.py does
    cfg = get_config(arch)
    times = []
    with torch.inference_mode():
        params = init_params(cfg, rng.PRNGKey(0), device=dev)
        prompts = synthetic_tokens(rng.PRNGKey(1), BATCH, PROMPT,
                                   cfg.vocab_size, device=dev)
        step = make_prefill_step(cfg, PROMPT + GEN)
        for i in range(2 + reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, {"tokens": prompts})
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        busy = device_busy(step, (params, {"tokens": prompts}))
    print(json.dumps({"ms": times, "device": torch.cuda.get_device_name(0),
                      "busy": busy}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.arch, args.reps)
        return 0
    if not args.other:
        ap.error("give the other checkout's directory")
    trees = {"other": Path(args.other).resolve() / "src", "this": THIS / "src"}
    runs = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        out = subprocess.run(
            [sys.executable, __file__, "--child", str(trees[name]), "--arch",
             args.arch, "--reps", str(args.reps)], capture_output=True,
            text=True, timeout=1200)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs[name] += res["ms"]
        print(f"{name} ({trees[name]}), {res['device']}: {args.arch} "
              f"prefill {BATCH}x{PROMPT} warm median "
              f"{statistics.median(res['ms']):.3f} ms over {args.reps} "
              f"calls (min {min(res['ms']):.3f})", flush=True)
        if res["busy"] is None:
            print("  device busy time: not measured (the trace holds no "
                  "device time)")
        else:
            busy, kernels = res["busy"]
            print(f"  device busy {busy:.3f} ms per call; largest: "
                  + "; ".join(f"{k[:60]} {ms:.3f}" for k, ms in kernels[:6]),
                  flush=True)
            port = [(k, ms) for k, ms in kernels if PORT_KERNELS.search(k)]
            mine = sum(ms for _, ms in port)
            print(f"  port kernels {mine:.3f} ms per call "
                  f"({100 * mine / busy:.1f}% of busy): "
                  + "; ".join(f"{short(k)} {ms:.3f}" for k, ms in port))
    med = {k: statistics.median(v) for k, v in runs.items()}
    print(json.dumps({"arch": args.arch, "median_ms": med,
                      "this_minus_other_ms": med["this"] - med["other"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
