#!/usr/bin/env python3
"""The SSD scan kernel (B5) of two checkouts of the port, in turns, on one
GPU.

    python3 tools/ssd_ab.py OTHER_CHECKOUT [--shapes NAME ...]

Builds ``src/repro_torch/csrc/ssd_scan.cu`` of OTHER_CHECKOUT (for
instance the parent commit, unpacked with ``git archive`` into
``build/``) and of this checkout with nvcc (the port's flags) into
``build/ssd_ab/``, prints both ptxas reports for the SSD kernels
(registers, spills, warnings), then at each serve shape (``SHAPES``: the
zamba2-2.7b and mamba2-370m prefills' calls, batch 4, prompt 1024, final
state on) holds both against ``ssd_scan_plain`` (atol 2e-4 + rtol 1e-3,
y and final state), times both in turns (other, this, this, other, three
times: six device times each, CUDA graphs of 20 calls, median of 20
replays), and prints each inner launch's device time (the profiler,
20 calls).  Prints the medians, this / other and the bound of
``chip_smoke.ssd_flops`` (3xTF32 operations at 495 TFLOP/s with C . B^T
counted once a group; bytes at 3.35 TB/s), with the card's name and power
limit.  Needs a CUDA GPU.
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

# name -> (BH, S, P, N, chunk, heads per group)
SHAPES = {
    "zamba2-2.7b": (320, 1024, 64, 64, 256, 80),
    "mamba2-370m": (128, 1024, 64, 128, 256, 32),
}
KERNELS = ("chunk_scores", "chunk_states", "state_pass", "chunk_scan")


def build(checkout: Path, name: str):
    """One checkout's ssd_scan.cu as a ctypes function, and ptxas's
    report."""
    from repro_torch.kernels import runtime

    out = THIS / "build" / "ssd_ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", str(out),
         str(checkout / "src/repro_torch/csrc/ssd_scan.cu")],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}"
                           f"{res.stderr}")
    fn = ctypes.CDLL(str(out)).ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 6 + [
        ctypes.c_void_p]
    return fn, res.stdout + res.stderr


def ptxas_report(log: str, label: str) -> None:
    """The SSD kernels' registers and spills, and every warning."""
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "warning" in line:
            print(f"ptxas {label}: {line.strip()}")
        elif entry and ("registers" in line or "spill" in line):
            kernel = re.search("|".join(KERNELS), entry)
            sizes = re.search(r"ILi(\d+)ELi(\d+)E", entry)
            if kernel and (sizes is None or sizes.groups() in
                           (("64", "64"), ("64", "128"))):
                tag = f"<{sizes[1]}, {sizes[2]}>" if sizes else ""
                print(f"ptxas {label} {kernel[0]}{tag}: {line.strip()}")


def launcher(fn, xdt, B, C, dA, y, state, chunk, hpg):
    from repro_torch.kernels.ssd_scan import scratch_floats

    bh, s, p = xdt.shape
    n = B.shape[-1]
    # room for either checkout's scratch layout
    floats = max(scratch_floats(bh, s, p, n, chunk, hpg),
                 bh * (s // chunk) * (n * p + 1))
    scratch = torch.empty(floats, device="cuda")

    def call():
        err = fn(xdt.data_ptr(), B.data_ptr(), C.data_ptr(), dA.data_ptr(),
                 None, y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
                 bh, s, p, n, chunk, hpg,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ssd_scan_launch: CUDA error {err}")
    return call


def launch_times(call) -> dict:
    """Each inner launch's device ms a call, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        kernel = re.search("|".join(KERNELS), e.key)
        if e.self_device_time_total > 0 and kernel:
            out[kernel[0]] = e.self_device_time_total / 20 / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--shapes", nargs="*", choices=list(SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from chip_smoke import (HBM_BYTES_PER_S, SSD_ATOL, SSD_RTOL,
                            TF32_OPS_PER_S, bound_ms, device_ms, nvidia_smi,
                            ssd_flops, ssd_inputs)
    from repro_torch.kernels.ssd_scan import ssd_scan_plain

    (other, log_other), (this, log) = (
        build(Path(args.other).resolve(), "other"), build(THIS, "this"))
    ptxas_report(log_other, "other")
    ptxas_report(log, "this")
    print(nvidia_smi())
    dev = torch.device("cuda", 0)
    rows = []
    for name in args.shapes or list(SHAPES):
        bh, s, p, n, chunk, hpg = SHAPES[name]
        xdt, B, C, dA = ssd_inputs(dev, bh, s, p, n, hpg, 31)
        want_y, want_st = ssd_scan_plain(xdt, B, C, dA, chunk, hpg)
        calls = {}
        for who, fn in (("other", other), ("this", this)):
            y, st = torch.empty_like(xdt), torch.empty(bh, n, p, device=dev)
            calls[who] = launcher(fn, xdt, B, C, dA, y, st, chunk, hpg)
            calls[who]()
            torch.cuda.synchronize()
            errs = [float((got - want).abs().max())
                    for got, want in ((y, want_y), (st, want_st))]
            ok = all(bool(((got - want).abs()
                           <= SSD_ATOL + SSD_RTOL * want.abs()).all())
                     for got, want in ((y, want_y), (st, want_st)))
            print(f"{name} {who}: max |err| y {errs[0]:.3g}, state "
                  f"{errs[1]:.3g}")
            if not ok:
                raise RuntimeError(f"{name} {who}: outside the tolerance")
        t = {"other": [], "this": []}
        for _ in range(3):
            for who in ("other", "this", "this", "other"):
                t[who].append(device_ms(calls[who]))
        med = {w: statistics.median(x) for w, x in t.items()}
        print(f"{name} {SHAPES[name]}: other "
              f"{[round(x, 6) for x in t['other']]}, this "
              f"{[round(x, 6) for x in t['this']]} ms")
        for who in ("other", "this"):
            inner = launch_times(calls[who])
            print(f"{name} {who} launches: "
                  + ", ".join(f"{k} {v:.6f} ms" for k, v in inner.items()))
        nbytes = 4 * (2 * xdt.numel() + B.numel() + C.numel() + dA.numel()
                      + bh * n * p)
        bound, by = bound_ms(nbytes, 3 * ssd_flops(bh, s, p, n, chunk, hpg),
                             TF32_OPS_PER_S)
        rows.append((name, med, bound, by,
                     nbytes / HBM_BYTES_PER_S * 1e3))
        del xdt, B, C, dA, calls
    print("shape | other ms | this ms | this/other | bound ms (by) | "
          "share of the bound (this) | bytes ms")
    for name, med, bound, by, bytes_ms in rows:
        print(f"{name} | {med['other']:.6f} | {med['this']:.6f} | "
              f"{med['this'] / med['other']:.3f} | {bound:.6f} ({by}) | "
              f"{bound / med['this']:.3f} | {bytes_ms:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
