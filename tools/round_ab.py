#!/usr/bin/env python3
"""Round times of the Mix2FLD main path for two checkouts of the port, in
turns, on one GPU.

    python3 tools/round_ab.py OTHER_CHECKOUT [--rounds 5]

Runs ``FederatedTrainer.round_once`` of ``repro_torch`` at the paper's
full width (mix2fld, D = 10, K = 200, B = 16, K_s = 160, synthetic
digits, 10 x 500 samples; the config of ``chip_smoke.py`` phase 3) for
``--rounds`` rounds, once from OTHER_CHECKOUT/src and once from this
checkout's src, each in a fresh process, in turns: other, this, this,
other.

Each turn prints every round's ``compute_s`` and ``local_s`` and the
conversion's time (a host clock around the trainer's eq. (5) call that
ends in ``torch.cuda.synchronize()``), and the medians over the steady
rounds (2 and later).  It then traces one more round with
``torch.profiler`` (device activity only) and prints the device's busy
time (the union of its operations' intervals), the round's wall time
under the trace and the idle share (1 - busy / wall), and traces one
local-SGD call and one conversion call on their own for the device
operations (kernels, copies, fills) and busy time per step.  Needs a
CUDA GPU.  ``chip_smoke.py`` imports :func:`busy_ms` from here.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

THIS = Path(__file__).resolve().parents[1]


def busy_ms(prof):
    """The device's busy time in a torch.profiler trace: the union of its
    operations' intervals (operations of a graph's parallel branches run
    at once, so their durations overlap)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def traced(fn):
    """Runs ``fn()`` under torch.profiler (device activity): (result,
    wall s, busy ms, device operations, kernels, largest [(name, ms)]);
    busy is the union of the operations' intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = busy_ms(prof)
    ops = sum(e.count for e in ev)
    kernels = sum(e.count for e in ev
                  if not e.key.startswith(("Memcpy", "Memset")))
    top = sorted(((e.key[:60], e.self_device_time_total / 1e3) for e in ev),
                 key=lambda kv: -kv[1])[:6]
    return out, wall, busy, ops, kernels, top


def child(src: str, rounds: int) -> None:
    sys.path.insert(0, src)
    import torch

    from repro_torch import rng
    from repro_torch.channel import ChannelConfig
    from repro_torch.core import protocols
    from repro_torch.core.protocols import FederatedConfig, FederatedTrainer
    from repro_torch.data import partition_iid, synthetic_images
    from repro_torch.models import CNN

    if not torch.cuda.is_available():
        raise SystemExit("round_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    x, y = synthetic_images(rng.PRNGKey(0), 6000, device=dev)
    dev_x, dev_y = (torch.as_tensor(a, device=dev) for a in partition_iid(
        x[:5000], y[:5000], 10, 500, 10, seed=0))
    test_x, test_y = x[5000:], y[5000:]
    fc = FederatedConfig(protocol="mix2fld", max_rounds=rounds)
    tr = FederatedTrainer(CNN(), fc, ChannelConfig(num_devices=10),
                          device=dev)
    # the conversion: the trainer's OutputToModel where it has one, else
    # the module function the round calls
    owner = tr if hasattr(tr, "output_to_model") else protocols
    convert = owner.output_to_model
    conv_s = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = convert(*args, **kwargs)
        torch.cuda.synchronize()
        conv_s.append(time.perf_counter() - t0)
        return out

    owner.output_to_model = timed
    state = tr.init_state(10)
    plan = tr.link_plan(state.g_params, n_links=10)
    recs = []
    for _ in range(rounds):
        state, rec = tr.round_once(state, dev_x, dev_y, test_x, test_y,
                                   plan=plan)
        recs.append(rec)
    owner.output_to_model = convert
    capture_s = [(round(g.warmup_s, 6), round(g.capture_s, 6)) for obj in (
        getattr(tr, "local_train", None), getattr(tr, "output_to_model", None))
        if hasattr(obj, "graphs") for g in obj.graphs]
    (state, _), wall, busy, ops, kernels, top = traced(
        lambda: tr.round_once(state, dev_x, dev_y, test_x, test_y,
                              plan=plan))
    local = getattr(tr, "local_train", None) or tr._local_train
    keys = rng.split(rng.PRNGKey(9, dev), 10)
    _, _, lbusy, lops, lkern, ltop = traced(lambda: local(
        state.dev_params, dev_x, dev_y, keys, state.dev_gout, True, fc.eta,
        fc.beta, dev_x.shape[1]))
    args = (state.g_params, state.seeds["train_x"], state.seeds["train_y"],
            state.gout, fc.server_iters, fc.server_batch, fc.eta, fc.beta,
            rng.PRNGKey(10, dev))
    conv_call = ((lambda: convert(*args)) if owner is tr else
                 (lambda: convert(tr.model.apply, *args)))
    _, _, cbusy, cops, ckern, _ = traced(conv_call)
    steady = slice(1, None)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "compute_s": [r["compute_s"] for r in recs],
        "local_s": [r["local_s"] for r in recs], "conversion_s": conv_s,
        "capture_s": capture_s,
        "median": {k: statistics.median(v[steady]) for k, v in (
            ("compute_s", [r["compute_s"] for r in recs]),
            ("local_s", [r["local_s"] for r in recs]),
            ("conversion_s", conv_s))},
        "traced_round": {"wall_s": wall, "busy_ms": busy,
                         "idle": 1.0 - busy / (wall * 1e3),
                         "device_ops": ops, "kernels": kernels, "top": top},
        "local_step": {"busy_ms": lbusy / fc.local_iters,
                       "device_ops": lops / fc.local_iters,
                       "kernels": lkern / fc.local_iters, "top": ltop},
        "conversion_step": {"busy_ms": cbusy / fc.server_iters,
                            "device_ops": cops / fc.server_iters,
                            "kernels": ckern / fc.server_iters}}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.rounds)
        return 0
    if not args.other:
        ap.error("give the other checkout's directory")
    trees = {"other": Path(args.other).resolve() / "src", "this": THIS / "src"}
    meds = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        cmd = [sys.executable, __file__, "--child", str(trees[name]),
               "--rounds", str(args.rounds)]
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1200)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        meds[name].append(res["median"])
        m, t = res["median"], res["traced_round"]
        ls, cs = res["local_step"], res["conversion_step"]
        print(f"{name} ({trees[name]}), {res['device']}: steady medians "
              f"compute_s {m['compute_s']:.6f}, local_s {m['local_s']:.6f}, "
              f"conversion_s {m['conversion_s']:.6f}", flush=True)
        for k in ("compute_s", "local_s", "conversion_s"):
            print(f"  {k} by round: {[round(v, 6) for v in res[k]]}")
        if res["capture_s"]:
            print(f"  (warm-up, capture) of the step graphs (round 1): "
                  f"{res['capture_s']} s")
        print(f"  traced round: wall {t['wall_s']:.6f} s, device busy "
              f"{t['busy_ms']:.3f} ms, idle {100 * t['idle']:.1f}%, "
              f"{t['device_ops']} device operations ({t['kernels']} kernels);"
              f" largest: " + "; ".join(f"{k} {ms:.3f}" for k, ms in t["top"]))
        print(f"  local step: {ls['kernels']:.2f} kernels "
              f"({ls['device_ops']:.2f} device operations), busy "
              f"{ls['busy_ms']:.6f} ms a step; conversion step: "
              f"{cs['kernels']:.2f} kernels ({cs['device_ops']:.2f}), busy "
              f"{cs['busy_ms']:.6f} ms a step", flush=True)
    summary = {name: {k: statistics.median(m[k] for m in ms)
                      for k in ("compute_s", "local_s", "conversion_s")}
               for name, ms in meds.items()}
    print(json.dumps({"median_of_turns": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
