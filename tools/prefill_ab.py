#!/usr/bin/env python3
"""Warm serve-prefill time of two checkouts of the port, in turns, on one GPU.

    python3 tools/prefill_ab.py OTHER_CHECKOUT [--arch qwen2-0.5b ...]
                                [--reps 20] [--batch B] [--prompt T]
                                [--layers N] [--tokens]

Times the prefill step of ``repro_torch`` at an architecture's published
widths (batch 4, prompt 1024, room for 32 generated tokens, as
``chip_smoke.py`` serves them: h2o-danube-3-4b at batch 2 and prompt
8192, qwen2-vl-72b at 8 of 80 layers and deepseek-v2-236b at 6 of 60,
``SHAPES``; random weights from PRNGKey(0), prompts from PRNGKey(1), an
embedding arch's stub embeddings a normal x 0.1 from PRNGKey(1)), once
from OTHER_CHECKOUT/src and once from this checkout's src,
each in a fresh process, in turns: other, this, this, other.  A turn
builds its checkout's kernels into that checkout's build/ directory,
makes two untimed calls, then times ``reps`` calls (host clock around the
call, ending in ``torch.cuda.synchronize()``).  Prints each turn's median
and peak device memory over the timed calls (``max_memory_allocated``
after a reset; the weights included) and, per checkout, the median over
all its calls and the difference.
Each turn then traces five more calls with ``torch.profiler`` and prints
the device's busy time per call (the sum of its kernels' device time)
and the kernels that take the most, then the port's own kernels (the
hand-written CUDA ones) with their share.  Several ``--arch`` run one
after the other.  With ``--tokens`` each turn also serves the greedy
tokens (``launch/serve.py``'s loop on the same weights, 32 new tokens)
and the script says whether the turns and the two checkouts gave the
same ones and, where the checkouts first differ, that step's top two
logits in each.  Needs a CUDA GPU.
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
# arch -> (batch, prompt, layers or None: the published depth), as
# chip_smoke.py serves it
SHAPES = {"h2o-danube-3-4b": (2, 8192, None), "qwen2-vl-72b": (4, 1024, 8),
          "deepseek-v2-236b": (4, 1024, 6)}
# the kernels of src/repro_torch/csrc that a prefill launches, by name
PORT_KERNELS = re.compile(r"flash_fwd|ssd_scan_kernel|chunk_scores|"
                          r"chunk_states|state_pass|chunk_scan")


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


def child(src: str, arch: str, reps: int, batch: int, prompt: int,
          layers, logits_out) -> None:
    sys.path.insert(0, src)
    import dataclasses

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
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    times = []
    with torch.inference_mode():
        params = init_params(cfg, rng.PRNGKey(0), device=dev)
        if cfg.embed_input:
            inputs = {"embeds": rng.normal(
                rng.PRNGKey(1, dev), (batch, prompt, cfg.d_model)) * 0.1}
        else:
            inputs = {"tokens": synthetic_tokens(
                rng.PRNGKey(1), batch, prompt, cfg.vocab_size, device=dev)}
        step = make_prefill_step(cfg, prompt + GEN)
        for i in range(2 + reps):
            if i == 2:
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, inputs)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = device_busy(step, (params, inputs))
    toks = top = None
    if logits_out:
        toks, top = greedy(cfg, params, batch, prompt, dev)
        prefill_logits(cfg, params, inputs, prompt, logits_out)
    print(json.dumps({"ms": times, "device": torch.cuda.get_device_name(0),
                      "busy": busy, "peak_gib": peak, "tokens": toks,
                      "top2": top}))


def prefill_logits(cfg, params, inputs, prompt, path) -> None:
    """The prefill's last-token logits (float32, on the CPU) into
    ``path``: ``"kernel"`` as the serve computes them, and ``"plain"``
    with the SSD scan's plain float32 route (``_ssd_chunked_plain``, the
    reference's einsums, the math the kernel's tolerance is held to) in
    place of the kernel."""
    import torch

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import mamba2

    step = make_prefill_step(cfg, prompt + GEN)
    out = {}
    scan = mamba2._ssd_chunked_scan
    try:
        for route in ("kernel", "plain"):
            if route == "plain":
                mamba2._ssd_chunked_scan = mamba2._ssd_chunked_plain
            with torch.inference_mode():
                out[route] = step(params, inputs)[0].float().cpu()
    finally:
        mamba2._ssd_chunked_scan = scan
    torch.save(out, path)


def greedy(cfg, params, batch, prompt, dev):
    """``launch/serve.py``'s greedy loop (its prompts, prefill and decode
    forward, the argmax of the logits), keeping each step's top two
    logits: (tokens (batch, GEN) as lists, top2[step][row] = (first
    value, its token, second value, its token))."""
    import torch

    from repro_torch import rng
    from repro_torch.data import synthetic_tokens
    from repro_torch.launch.serve import stub_encoder
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import forward

    with torch.inference_mode():
        prompts = synthetic_tokens(rng.PRNGKey(1), batch, prompt,
                                   cfg.vocab_size, device=dev)
        extra = stub_encoder(cfg, batch, dev)
        logits, cache = make_prefill_step(cfg, prompt + GEN)(
            params, {"tokens": prompts, **extra})
        toks, top = [], []
        for step in range(GEN):
            if step:
                logits, _, cache = forward(
                    cfg, params, {"tokens": nxt[:, None], **extra},
                    cache=cache)
                logits = logits[:, -1]
            nxt = torch.argmax(logits, dim=-1)
            v, i = torch.topk(logits.float(), 2, dim=-1)
            toks.append(nxt.tolist())
            top.append([(a[0], b[0], a[1], b[1])
                        for a, b in zip(v.tolist(), i.tolist())])
    return [list(r) for r in zip(*toks)], top


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--arch", nargs="+", default=["qwen2-0.5b"])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int)
    ap.add_argument("--prompt", type=int)
    ap.add_argument("--layers", type=int)
    ap.add_argument("--tokens", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--logits", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        arch = args.arch[0]
        batch, prompt, layers = SHAPES.get(arch, (BATCH, PROMPT, None))
        child(args.child, arch, args.reps, args.batch or batch,
              args.prompt or prompt, args.layers or layers, args.logits)
        return 0
    if not args.other:
        ap.error("give the other checkout's directory")
    for arch in args.arch:
        if compare(args, arch):
            return 1
    return 0


def report_tokens(arch, served, logits) -> None:
    """Whether each checkout's turns gave the same greedy tokens, whether
    the two checkouts did, and at the first step where they differ the
    top two logits of that row in both (the same history up to it); then
    the prefill's logits of the two checkouts' first turns against each
    other and against the plain float32 scan's (``prefill_logits``):
    the largest difference over the batch and the vocabulary, and at the
    first differing row the two tokens' logits on each route."""
    by = {name: [t for n, t, _ in served if n == name]
          for name in ("other", "this")}
    for name, runs in by.items():
        print(f"{arch}: {name}'s turns give the same tokens: "
              f"{all(t == runs[0] for t in runs)}")
    (_, a, top_a), (_, b, top_b) = served[0], served[1]   # other, this
    where = next(((step, row) for step in range(GEN)
                  for row in range(len(a)) if a[row][step] != b[row][step]),
                 None)
    print(f"{arch}: the two checkouts' greedy tokens equal: {where is None}"
          + ("" if where is None else f"; first difference at step "
             f"{where[0]}, row {where[1]}"))
    if where is not None:
        step, row = where
        for name, top in (("other", top_a), ("this", top_b)):
            v1, t1, v2, t2 = top[step][row]
            print(f"{arch}: {name} step {step} row {row}: top logits "
                  f"{v1!r} (token {t1}) and {v2!r} (token {t2}), apart "
                  f"{v1 - v2!r}")
    import torch

    got = {name: torch.load(logits / f"{arch}-{turn}.pt")
           for turn, name in ((0, "other"), (1, "this"))}
    routes = {"other": got["other"]["kernel"], "this": got["this"]["kernel"],
              "plain (other)": got["other"]["plain"],
              "plain (this)": got["this"]["plain"]}
    pairs = [("this", "other"), ("other", "plain (other)"),
             ("this", "plain (this)"), ("plain (this)", "plain (other)")]
    print(f"{arch}: prefill logits, largest |difference| over "
          f"{tuple(routes['this'].shape)}: " + "; ".join(
              f"{a} vs {b} {float((routes[a] - routes[b]).abs().max())!r}"
              for a, b in pairs))
    row = where[1] if where is not None and where[0] == 0 else 0
    toks = sorted({top_a[0][row][1], top_a[0][row][3], top_b[0][row][1],
                   top_b[0][row][3]})
    print(f"{arch}: prefill row {row}, tokens {toks}: " + "; ".join(
        f"{name} {[float(routes[name][row, t]) for t in toks]}"
        for name in ("other", "this", "plain (other)")))


def compare(args, arch) -> int:
    """One arch's four turns; non-zero if a turn failed."""
    batch, prompt, layers = SHAPES.get(arch, (BATCH, PROMPT, None))
    batch, prompt = args.batch or batch, args.prompt or prompt
    layers = args.layers or layers
    trees = {"other": Path(args.other).resolve() / "src", "this": THIS / "src"}
    runs = {"other": [], "this": []}
    served = []
    logits = THIS / "build" / "prefill_ab"
    logits.mkdir(parents=True, exist_ok=True)
    for turn, name in enumerate(("other", "this", "this", "other")):
        out = subprocess.run(
            [sys.executable, __file__, "--child", str(trees[name]), "--arch",
             arch, "--reps", str(args.reps), "--batch", str(batch),
             "--prompt", str(prompt)]
            + (["--layers", str(layers)] if layers else [])
            + (["--logits", str(logits / f"{arch}-{turn}.pt")]
               if args.tokens else []),
            capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs[name] += res["ms"]
        served.append((name, res["tokens"], res["top2"]))
        print(f"{name} ({trees[name]}), {res['device']}: {arch} "
              + (f"({layers} layers) " if layers else "")
              + f"prefill {batch}x{prompt} warm median "
              f"{statistics.median(res['ms']):.3f} ms over {args.reps} "
              f"calls (min {min(res['ms']):.3f}), peak device memory "
              f"{res['peak_gib']:.3f} GiB", flush=True)
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
    if args.tokens:
        report_tokens(arch, served, logits)
    print(json.dumps({"arch": arch, "median_ms": med,
                      "this_minus_other_ms": med["this"] - med["other"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
