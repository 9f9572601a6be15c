#!/usr/bin/env python3
"""The flash-attention kernel (B4) of two checkouts of the port, in turns,
on one GPU, beside PyTorch's SDPA.

    python3 tools/flash_ab.py OTHER_CHECKOUT [--dtype bfloat16|float32]
                              [--calls NAME ...]

Builds ``src/repro_torch/csrc/flash_attention.cu`` of OTHER_CHECKOUT and
of this checkout with nvcc (the port's flags) into ``build/flash_ab/``,
prints both checkouts' ptxas reports for the dtype's instantiations
(registers, spills, warnings), then, at each call of the dtype's calls
(bfloat16: ``CALLS``, the LM prefills' (BH, S, d, dv, window); float32:
``F32_CALLS``, the smoke, classifier and favg calls), holds both against
``attention_plain`` (a few heads at a time; bfloat16 within 2 * 2**-6
and ``bf16_excess`` <= 1, float32 within 2e-5) and times them: device
time per launch (CUDA graphs of launches, median over replays, CUDA
events), in turns: other, this, SDPA, SDPA, this, other, three times.
Prints the medians, this / other, this / SDPA and the bound: the larger
of the bytes over 3.35 TB/s and the operations over the peak (bfloat16:
989 TFLOP/s; float32: 67 TFLOP/s on the CUDA cores and, beside it, three
products at 495 TFLOP/s, the 3xTF32 bound).  ``CHECKS`` and
``F32_CHECKS`` (off the tiles, with windows) are only held to the plain
version.  Needs a CUDA GPU.
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
# float32: name -> (BH, S, d, dv, window)
F32_CALLS = {
    "deepseek-v2 width192": (8, 40, 192, 128, None),
    "deepseek-v2 smoke": (8, 40, 48, 32, None),
    "classifier": (400, 16, 16, 16, None),
    "zamba2 smoke favg": (8, 64, 32, 32, None),
    "favg 25m": (32, 128, 64, 64, None),
    "favg 100m": (48, 128, 64, 64, None),
    "favg 25m seq 1024": (32, 1024, 64, 64, None),
}
F32_CHECKS = ((4, 300, 128, 128, 7), (8, 160, 192, 128, None),
              (3, 333, 80, 80, 100), (2, 1, 32, 32, None),
              (8, 300, 120, 120, None), (3, 200, 16, 128, 50))
F32_ATOL = 2e-5


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


def ptxas_report(log: str, label: str, f32: bool) -> None:
    """The dtype's kernels' registers and spills, and every warning."""
    entry = None
    pattern = (r"flash_fwd_(?:f32|kernel)I?\w*?Li(\d+)ELi(\d+)E" if f32
               else r"flash_fwd_tcILi(\d+)ELi(\d+)E")
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "warning" in line:
            print(f"ptxas {label}: {line.strip()}")
        elif entry and ("registers" in line or "spill" in line):
            m = re.search(pattern, entry)
            if m:
                kernel = re.search(r"flash_fwd_[a-z0-9]+", entry)[0]
                print(f"ptxas {label} {kernel}<{m[1]}, {m[2]}>: "
                      f"{line.strip()}")


def launcher(fn, q, k, v, out, window):
    bh, s, d = q.shape
    dtype = 0 if q.dtype == torch.float32 else 1

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, s, d, v.shape[-1], window or -1, dtype,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_launch: CUDA error {err}")
    return call


def inputs(gen, bh, s, d, dv, dtype=torch.bfloat16):
    q, k = (torch.randn(bh, s, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, torch.randn(bh, s, dv, generator=gen,
                             device="cuda").to(dtype)


def hold(libs, q, k, v, window, label):
    """Both libraries' outputs against the plain version."""
    from chip_smoke import plain_by_heads
    from repro_torch.kernels.flash_attention import bf16_excess

    f32 = q.dtype == torch.float32
    want = plain_by_heads(q, k, v, window)
    calls = {}
    for name, fn in libs.items():
        out = torch.empty(q.shape[:2] + v.shape[2:], dtype=q.dtype,
                          device="cuda")
        calls[name] = launcher(fn, q, k, v, out, window)
        calls[name]()
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        x = 0.0 if f32 else bf16_excess(out, want)
        print(f"{label} {name}: max |err| {err:.3g}"
              + ("" if f32 else f", {x:.3f} of the per-element bound"))
        if err > (F32_ATOL if f32 else ATOL) or x > 1:
            raise RuntimeError(f"{label} {name}: err {err}, excess {x}")
    return calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--calls", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from chip_smoke import (BF16_OPS_PER_S, F32_OPS_PER_S, TF32_OPS_PER_S,
                            attended_pairs, bound_ms, device_ms, nvidia_smi)

    f32 = args.dtype == "float32"
    dtype = torch.float32 if f32 else torch.bfloat16
    table, checks = (F32_CALLS, F32_CHECKS) if f32 else (CALLS, CHECKS)
    (other, log_other), (this, log) = (
        build(Path(args.other).resolve(), "other"), build(THIS, "this"))
    ptxas_report(log_other, "other", f32)
    ptxas_report(log, "this", f32)
    libs = {"other": other, "this": this}
    print(nvidia_smi())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for bh, s, d, dv, window in checks:
        hold(libs, *inputs(gen, bh, s, d, dv, dtype), window,
             f"check {(bh, s, d, dv)} {args.dtype} window {window}")
    rows = []
    for name in args.calls or list(table):
        bh, s, d, dv, window = table[name]
        q, k, v = inputs(gen, bh, s, d, dv, dtype)
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
        nbytes = 2 * bh * s * (d + dv) * q.element_size()
        ops = 2 * pairs * (d + dv)
        bounds = ([bound_ms(nbytes, ops, F32_OPS_PER_S),
                   bound_ms(nbytes, 3 * ops, TF32_OPS_PER_S)] if f32
                  else [bound_ms(nbytes, ops, BF16_OPS_PER_S)])
        print(f"{name} {(bh, s, d, dv)} window {window}: other "
              f"{[round(x, 6) for x in t['other']]}, this "
              f"{[round(x, 6) for x in t['this']]}, sdpa "
              f"{[round(x, 6) for x in t['sdpa']]} ms")
        rows.append((name, (bh, s, d, dv, window), med, bounds))
        del q, k, v, calls
    print("call | other ms | this ms | this/other | SDPA ms | this/SDPA | "
          "bound ms (by) and share of it"
          + (": float32 CUDA cores; 3xTF32" if f32 else ""))
    for name, shape, med, bounds in rows:
        shares = "; ".join(f"{b:.6f} ({by}) {b / med['this']:.3f}"
                           for b, by in bounds)
        print(f"{name} {shape} | {med['other']:.6f} | {med['this']:.6f} | "
              f"{med['this'] / med['other']:.3f} | {med['sdpa']:.6f} | "
              f"{med['this'] / med['sdpa']:.3f} | {shares}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
