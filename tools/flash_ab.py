#!/usr/bin/env python3
"""The flash-attention kernel (B4, bfloat16) of two checkouts of the port,
in turns, on one GPU, beside PyTorch's SDPA.

    python3 tools/flash_ab.py OTHER_CHECKOUT [--calls NAME ...]

Builds ``src/repro_torch/csrc/flash_attention.cu`` of OTHER_CHECKOUT and
of this checkout with nvcc (the port's flags) into ``build/flash_ab/``,
prints both checkouts' ptxas reports for the tensor-core instantiations
(registers, spills, warnings), then, at each call of ``CALLS`` (the LM
prefills' (BH, S, d, dv, window)), holds both against
``attention_plain`` (a few heads at a time) within 2 * 2**-6 and
``bf16_excess`` <= 1, and times them: device time per launch (CUDA
graphs of launches, median over replays, CUDA events), in turns: other,
this, SDPA, SDPA, this, other, three times.  Prints the medians, this /
other, this / SDPA and the bound (the larger of the bytes over 3.35 TB/s
and the operations over 989 TFLOP/s).  ``CHECKS`` (S 1084: the last
query tile's second warpgroup has no row below S) are only held to the
plain version.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

THIS = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(THIS / "src"))
sys.path.insert(0, str(THIS))

# name -> (BH, S, d, dv, window)
CALLS = {
    "qwen2-vl-72b": (256, 1024, 128, 128, None),
    "qwen3-14b": (160, 1024, 128, 128, None),
    "deepseek-v2": (512, 1024, 192, 128, None),
    "phi3-mini": (128, 1024, 96, 96, None),
    "zamba2-2.7b": (128, 1024, 80, 80, None),   # window 4096 >= S: none
    "qwen2-moe": (64, 1024, 128, 128, None),
    "h2o-danube3": (64, 8192, 120, 120, 4096),
    "qwen2-0.5b": (56, 1024, 64, 64, None),
    "whisper-medium": (64, 1024, 64, 64, None),
    "favg": (56, 512, 64, 64, None),
    "d32": (56, 1024, 32, 32, None),
}
CHECKS = ((4, 1084, 128, 128, None), (4, 1084, 192, 128, None),
          (1, 1084, 128, 128, 300), (1, 128, 128, 128, None),
          (3, 384, 128, 128, None), (3, 512, 192, 128, 200))
ATOL = 2 * 2.0 ** -6


def build(checkout: Path, name: str):
    """One checkout's flash_attention.cu as a ctypes library, and ptxas's
    report."""
    from repro_torch.kernels import runtime

    out = THIS / "build" / "flash_ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", str(out),
         str(checkout / "src/repro_torch/csrc/flash_attention.cu")],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}"
                           f"{res.stderr}")
    fn = ctypes.CDLL(str(out)).flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 + [
        ctypes.c_void_p]
    return fn, res.stdout + res.stderr


def ptxas_report(log: str, label: str) -> None:
    """The tensor-core kernels' registers and spills, and every warning."""
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "warning" in line:
            print(f"ptxas {label}: {line.strip()}")
        elif entry and "flash_fwd_tc" in entry and (
                "registers" in line or "spill" in line):
            m = re.search(r"flash_fwd_tcILi(\d+)ELi(\d+)E", entry)
            print(f"ptxas {label} flash_fwd_tc<{m[1]}, {m[2]}>: "
                  f"{line.strip()}")


def launcher(fn, q, k, v, out, window):
    bh, s, d = q.shape

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, s, d, v.shape[-1], window or -1, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_launch: CUDA error {err}")
    return call


def inputs(gen, bh, s, d, dv):
    q, k = (torch.randn(bh, s, d, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    return q, k, torch.randn(bh, s, dv, generator=gen,
                             device="cuda").bfloat16()


def hold(libs, q, k, v, window, label):
    """Both libraries' outputs against the plain version."""
    from chip_smoke import plain_by_heads
    from repro_torch.kernels.flash_attention import bf16_excess

    want = plain_by_heads(q, k, v, window)
    calls = {}
    for name, fn in libs.items():
        out = torch.empty(q.shape[:2] + v.shape[2:], dtype=q.dtype,
                          device="cuda")
        calls[name] = launcher(fn, q, k, v, out, window)
        calls[name]()
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        x = bf16_excess(out, want)
        print(f"{label} {name}: max |err| {err:.3g}, {x:.3f} of the "
              f"per-element bound")
        if err > ATOL or x > 1:
            raise RuntimeError(f"{label} {name}: err {err}, excess {x}")
    return calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--calls", nargs="*", default=list(CALLS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from chip_smoke import (BF16_OPS_PER_S, attended_pairs, bound_ms,
                            device_ms, nvidia_smi)

    (other, log_other), (this, log) = (
        build(Path(args.other).resolve(), "other"), build(THIS, "this"))
    ptxas_report(log_other, "other")
    ptxas_report(log, "this")
    libs = {"other": other, "this": this}
    print(nvidia_smi())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for bh, s, d, dv, window in CHECKS:
        hold(libs, *inputs(gen, bh, s, d, dv), window,
             f"check {(bh, s, d, dv)} window {window}")
    rows = []
    for name in args.calls:
        bh, s, d, dv, window = CALLS[name]
        q, k, v = inputs(gen, bh, s, d, dv)
        calls = hold(libs, q, k, v, window, f"{name} {(bh, s, d, dv)}")
        if window is None:
            def lib():
                return F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True)
        else:
            pos = torch.arange(s, device="cuda")
            keep = ((pos[None, :] <= pos[:, None])
                    & (pos[:, None] - pos[None, :] < window))

            def lib():
                return F.scaled_dot_product_attention(
                    q[None], k[None], v[None], attn_mask=keep)
        reps = (10, 5) if s >= 4096 else (20, 20)
        t = {"other": [], "this": [], "sdpa": []}
        for _ in range(3):
            for who in ("other", "this", "sdpa", "sdpa", "this", "other"):
                t[who].append(device_ms(lib if who == "sdpa"
                                        else calls[who], *reps))
        med = {w: statistics.median(x) for w, x in t.items()}
        pairs = attended_pairs(bh, s, window)
        bound, by = bound_ms(2 * bh * s * (d + dv) * 2,
                             2 * pairs * (d + dv), BF16_OPS_PER_S)
        print(f"{name} {(bh, s, d, dv)} window {window}: other "
              f"{[round(x, 6) for x in t['other']]}, this "
              f"{[round(x, 6) for x in t['this']]}, sdpa "
              f"{[round(x, 6) for x in t['sdpa']]} ms")
        rows.append((name, (bh, s, d, dv, window), med, bound, by))
        del q, k, v, calls
    print("call | other ms | this ms | this/other | SDPA ms | this/SDPA | "
          "bound ms | share of bound")
    for name, shape, med, bound, by in rows:
        print(f"{name} {shape} | {med['other']:.6f} | {med['this']:.6f} | "
              f"{med['this'] / med['other']:.3f} | {med['sdpa']:.6f} | "
              f"{med['this'] / med['sdpa']:.3f} | {bound:.6f} ({by}) | "
              f"{bound / med['this']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
