#!/usr/bin/env python3
"""Where the bfloat16 flash kernel's consumer warpgroups spend their
cycles, on one GPU.

    python3 tools/flash_phases.py [--calls NAME ...]

Builds a copy of ``src/repro_torch/csrc/flash_attention.cu`` into
``build/flash_phases/`` with ``clock64()`` read by every consumer thread
at the ends of the phases of its key-tile loop, summed in registers and
added, by the first thread of each warpgroup, into a device counter a
phase a warpgroup.  Runs B4 once at each call of ``tools/flash_ab.py``'s
``CALLS`` (the LM prefills' shapes) and prints, per warpgroup, the
cycles of each phase summed over the CTAs, their share, and the cycles a
key tile of the loop (tiles after the first of each query tile).  The
phases are found by the statements of the source; the script fails if
one is missing.  The counters take cycles themselves: read the shares
more than the sum.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

# (anchor in the source, phase that ends there); each anchor is found
# once in the consumer and the probe goes right after it
PHASES = [
    ("      auto prv = cur;  // the V tile of the next P V\n",
     "Q, the first tile (prologue)"),
    ("        bar_wait<OUT_OF_LINE>(&b.v_full[prv.st], prv.ph);\n"
     "        __syncwarp();\n", "wait for K_i, V_{i-1}"),
    ("        turn_wait();\n", "wait for the turn"),
    ("        if (wg == 0 || i + 1 < n_tiles) turn_pass();\n",
     "issue S_i, P_{i-1} V_{i-1}"),
    ("        wg_wait_one();  // S_i is in; P_{i-1} V_{i-1} may still run\n",
     "wait for S_i"),
    ("        softmax_exp(sc, m, l, alpha, (t_first + i) * BK, r_wg, row0, "
     "col0, s,\n                    window, scale_log2);\n",
     "softmax of tile i"),
    ("        wg_wait_all();\n", "wait for P_{i-1} V_{i-1}"),
    ("        cur.next();\n      }\n", "pack P_i, rescale"),
    ("        bar_arrive(&b.q_empty[qb]);  // a later query tile may take "
     "them\n      }\n", "last P V, epilogue"),
]
LOOP = [1, 2, 3, 4, 5, 6, 7]   # the phases of a loop tile
N = len(PHASES)


def instrumented() -> str:
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    head = ("__device__ unsigned long long flash_phases[2 * %d];\n" % N
            + "#define PH(k) { const unsigned long long n_ = clock64(); "
              "ph[k] += n_ - ph_t; ph_t = n_; }\n")
    anchor = "namespace tc {\n"
    if src.count(anchor) != 1:
        raise RuntimeError("flash_attention.cu changed: no tc namespace")
    src = src.replace(anchor, anchor + head)
    anchor = "  Ring<L::stages(Q_BUFS)> cur;  // the K (and V) tile of the next Q K^T\n"
    if src.count(anchor) != 1:
        raise RuntimeError("flash_attention.cu changed: no ring to start at")
    src = src.replace(anchor, anchor + "  unsigned long long ph_t = "
                      "clock64(), ph[%d] = {};\n" % N)
    for k, (text, name) in enumerate(PHASES):
        if src.count(text) != 1:
            raise RuntimeError(f"phase {name!r}: its anchor is found "
                               f"{src.count(text)} times")
        if k == N - 2:   # the loop's last statement, in the loop
            head, close = text.rstrip("\n").rsplit("\n", 1)
            src = src.replace(text, f"{head}\n        PH({k});\n{close}\n")
        else:
            src = src.replace(text, text + f"      PH({k});\n")
    tail = "  }\n}\n\n// Warp specialisation"
    if src.count(tail) != 1:
        raise RuntimeError("flash_attention.cu changed: no consumer end")
    src = src.replace(tail, "  }\n  if ((threadIdx.x & 127) == 0)\n"
                      f"    for (int k = 0; k < {N}; ++k)\n"
                      f"      atomicAdd(&flash_phases[wg * {N} + k], ph[k]);"
                      "\n}\n\n// Warp specialisation")
    src += ("\nextern \"C\" int flash_phase_cycles(unsigned long long* out) "
            "{\n  int e = (int)cudaMemcpyFromSymbol(out, tc::flash_phases, "
            "sizeof(tc::flash_phases));\n  static unsigned long long "
            "zero[2 * %d] = {};\n  if (e == 0) e = (int)cudaMemcpyToSymbol("
            "tc::flash_phases, zero, sizeof(zero));\n  return e;\n}\n" % N)
    return src


def build():
    from repro_torch.kernels import runtime

    out = ROOT / "build" / "flash_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attention.cu").write_text(instrumented())
    (out / "hopper.cuh").write_text(
        (ROOT / "src/repro_torch/csrc/hopper.cuh").read_text())
    subprocess.run([runtime._nvcc(), *runtime.NVCC_FLAGS, "-o",
                    str(out / "flash.so"), str(out / "flash_attention.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out / "flash.so"))
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 + [ctypes.c_void_p])
    lib.flash_phase_cycles.restype = ctypes.c_int
    lib.flash_phase_cycles.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    from flash_ab import CALLS

    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", nargs="*", default=list(CALLS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from chip_smoke import nvidia_smi

    lib = build()
    print(nvidia_smi())
    gen = torch.Generator(device="cuda").manual_seed(0)
    counts = (ctypes.c_ulonglong * (2 * N))()
    for name in args.calls:
        bh, s, d, dv, window = CALLS[name]
        q, k = (torch.randn(bh, s, d, generator=gen, device="cuda")
                .bfloat16() for _ in range(2))
        v = torch.randn(bh, s, dv, generator=gen, device="cuda").bfloat16()
        o = torch.empty(bh, s, dv, dtype=q.dtype, device="cuda")
        for _ in range(2):   # the second launch is the one read
            if lib.flash_phase_cycles(counts):
                raise RuntimeError("flash_phase_cycles failed")
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh,
                s, d, dv, window or -1, 1,
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        if lib.flash_phase_cycles(counts):
            raise RuntimeError("flash_phase_cycles failed")
        n_qt = (s + 127) // 128
        tiles = 0
        for q0 in range(0, s, 128):
            first = max(0, q0 - window + 1) // 128 if window else 0
            tiles += (min(q0 + 128, s) - 1) // 128 - first   # loop tiles
        loop_tiles = bh * tiles
        print(f"{name} {(bh, s, d, dv)} window {window}: {bh * n_qt} query "
              f"tiles, {loop_tiles} loop tiles")
        for wg in range(2):
            c = list(counts[wg * N:(wg + 1) * N])
            total = sum(c)
            per_tile = sum(c[i] for i in LOOP) / max(loop_tiles, 1)
            print(f"  warpgroup {wg}: {total:,} cycles; a loop tile "
                  f"{per_tile:,.0f}")
            for (_, phase), cyc in zip(PHASES, c):
                print(f"    {phase:30s} {cyc:>16,} {cyc / total:7.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
