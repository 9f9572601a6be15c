#!/usr/bin/env python3
"""Where the flash kernels' warps spend their cycles, on one GPU.

    python3 tools/flash_phases.py [--dtype bfloat16|float32] [--calls NAME ...]

Builds a copy of ``src/repro_torch/csrc/flash_attention.cu`` into
``build/flash_phases/`` with ``clock64()`` read at the ends of the phases
of the kernels' key-tile loops, summed in registers and added into a
device counter a phase.  bfloat16 (``flash_fwd_tc``): probes inserted
after statements of the source (the script fails if one is missing);
every consumer thread reads the clock, the first thread of each consumer
warpgroup adds its sums.  float32: the source's ``F32_PROBE`` marks,
defined here; in ``flash_fwd_f32`` (one warpgroup a CTA) and in each
warpgroup of ``flash_fwd_f32_ws`` (the multiplier, the splitter) the
first thread of the second warp adds its sums.  Runs B4 once at each call
of ``tools/flash_ab.py``'s calls of that dtype and prints, for each group
that ran, the cycles of each phase summed over the CTAs, their share, and
the cycles a key tile of the loop (tiles after the first of each query
tile).  The counters take cycles themselves: read the shares more than
the sum.  Needs a CUDA GPU.
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
BF16_PHASES = [
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
# the float32 kernels' probes (F32_PROBE in the source): group -> (what
# runs it, its phases in probe order, the probes of a key tile's loop)
F32_MULTIPLIER = (["Q (prologue)", "wait for the buffer",
                   "turn, issue S_i", "wait for S_i", "barrier, refill",
                   "softmax, rescale, split P, turn, issue P_i V_i",
                   "wait for P_i V_i", "epilogue"], range(1, 7))
F32_GROUPS = {
    0: ("flash_fwd_f32 (one warpgroup)",
        ["Q, K_0 and their splits (prologue)", "issue S_i",
         "transpose and split V_i", "wait for S_i", "barrier, refill",
         "softmax, rescale, split P, issue P_i V_i",
         "wait for K_{i+1}, split it", "wait for P_i V_i", "barrier",
         "epilogue"], range(1, 9)),
    1: ("flash_fwd_f32_ws, multiplier 0",) + F32_MULTIPLIER,
    3: ("flash_fwd_f32_ws, multiplier 1",) + F32_MULTIPLIER,
    2: ("flash_fwd_f32_ws, the splitter",
        ["loads, Q's split (prologue)", "wait for K_i, V_i",
         "load K_i, V_i", "wait for a free buffer",
         "write K_i's split, V_i's transpose", "barrier, ready"],
        range(1, 6)),
}
F32_SLOTS = 16
F32_PROBES = f"""
__device__ unsigned long long flash_phases[{4 * F32_SLOTS}];
#define F32_PROBE_START \\
  unsigned long long ph_t = clock64(), ph[{F32_SLOTS}] = {{}};
#define F32_PROBE(k) \\
  {{ const unsigned long long n_ = clock64(); ph[k] += n_ - ph_t; ph_t = n_; }}
#define F32_PROBE_END(group, adder) \\
  if (adder) \\
    for (int k_ = 0; k_ < {F32_SLOTS}; ++k_) \\
      atomicAdd(&flash_phases[(group) * {F32_SLOTS} + k_], ph[k_]);
"""
BF16_START = ("  Ring<L::stages(Q_BUFS)> cur;  // the K (and V) tile of the "
              "next Q K^T\n")
BF16_TAIL = "  }\n}\n\n// Warp specialisation"


def reader(n) -> str:
    return ("\nextern \"C\" int flash_phase_cycles(unsigned long long* out) "
            "{\n  int e = (int)cudaMemcpyFromSymbol(out, flash_phases, "
            "sizeof(flash_phases));\n  static unsigned long long "
            "zero[%d] = {};\n  if (e == 0) e = (int)cudaMemcpyToSymbol("
            "flash_phases, zero, sizeof(zero));\n  return e;\n}\n" % n)


def instrumented(dtype) -> str:
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    if dtype == "float32":
        if "F32_PROBE(" not in src:
            raise RuntimeError("flash_attention.cu changed: no F32_PROBE")
        return F32_PROBES + src + reader(4 * F32_SLOTS)
    n = len(BF16_PHASES)
    head = ("__device__ unsigned long long flash_phases[%d];\n" % (2 * n)
            + "#define PH(k) { const unsigned long long n_ = clock64(); "
              "ph[k] += n_ - ph_t; ph_t = n_; }\n")
    anchor = "namespace tc {\n"
    if src.count(anchor) != 1:
        raise RuntimeError("flash_attention.cu changed: no tc namespace")
    src = src.replace(anchor, head + anchor)
    if src.count(BF16_START) != 1:
        raise RuntimeError("flash_attention.cu changed: no ring to start at")
    src = src.replace(BF16_START, BF16_START + "  unsigned long long ph_t = "
                      "clock64(), ph[%d] = {};\n" % n)
    for k, (text, name) in enumerate(BF16_PHASES):
        if src.count(text) != 1:
            raise RuntimeError(f"phase {name!r}: its anchor is found "
                               f"{src.count(text)} times")
        if k == n - 2:   # the loop's last statement, in the loop
            head, close = text.rstrip("\n").rsplit("\n", 1)
            src = src.replace(text, f"{head}\n        PH({k});\n{close}\n")
        else:
            src = src.replace(text, text + f"      PH({k});\n")
    if src.count(BF16_TAIL) != 1:
        raise RuntimeError("flash_attention.cu changed: no consumer end")
    src = src.replace(BF16_TAIL, "  }\n  if ((threadIdx.x & 127) == 0)\n"
                      f"    for (int k = 0; k < {n}; ++k)\n"
                      f"      atomicAdd(&flash_phases[wg * {n} + k], ph[k]);"
                      "\n}\n\n// Warp specialisation")
    return src + reader(2 * n)


def build(dtype):
    from repro_torch.kernels import runtime

    out = ROOT / "build" / "flash_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attention.cu").write_text(instrumented(dtype))
    (out / "hopper.cuh").write_text(
        (ROOT / "src/repro_torch/csrc/hopper.cuh").read_text())
    subprocess.run([runtime._nvcc(), *runtime.NVCC_FLAGS, "-o",
                    str(out / "flash.so"), str(out / "flash_attention.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out / "flash.so"))
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int64)]
        + [ctypes.c_int64] * 9 + [ctypes.c_void_p])
    lib.flash_phase_cycles.restype = ctypes.c_int
    lib.flash_phase_cycles.argtypes = [ctypes.c_void_p]
    return lib


def loop_tiles(bh, s, window, bq, bk):
    """Key tiles after the first of each query tile, over the call."""
    tiles = 0
    for q0 in range(0, s, bq):
        first = max(0, q0 - window + 1) // bk if window else 0
        tiles += (min(q0 + bq, s) - 1) // bk - first
    return bh * tiles


def main() -> int:
    from flash_ab import CALLS, F32_CALLS

    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--calls", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from chip_smoke import nvidia_smi
    from repro_torch.kernels.flash_attention import tma_strides

    f32 = args.dtype == "float32"
    calls = F32_CALLS if f32 else CALLS
    dtype = torch.float32 if f32 else torch.bfloat16
    lib = build(args.dtype)
    layout = lib.flash_attention_f32_layout
    layout.restype = ctypes.c_int64
    layout.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p]
    print(nvidia_smi())
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = 4 * F32_SLOTS if f32 else 2 * len(BF16_PHASES)
    counts = (ctypes.c_ulonglong * n)()
    for name in args.calls or list(calls):
        B, H, Hkv, s, d, dv, window, rope = calls[name]
        bh = B * H
        q = torch.randn(B, s, H, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, s, Hkv, d - rope, generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn(B, s, Hkv, dv, generator=gen, device="cuda").to(dtype)
        ks = (torch.randn(B, s, rope, generator=gen, device="cuda").to(dtype)
              if rope else None)
        o = torch.empty(B, s, H, dv, dtype=q.dtype, device="cuda")
        strides = (ctypes.c_int64 * 15)(*tma_strides(q, k, v, ks))
        for _ in range(2):   # the second launch is the one read
            if lib.flash_phase_cycles(counts):
                raise RuntimeError("flash_phase_cycles failed")
            err = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if ks is None else ks.data_ptr(), o.data_ptr(), strides,
                B, H, Hkv, s, d, d - rope, dv, window or -1, 0 if f32 else 1,
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        if lib.flash_phase_cycles(counts):
            raise RuntimeError("flash_phase_cycles failed")
        if f32:
            bk, st = ctypes.c_int64(), ctypes.c_int64()
            layout(d, dv, ctypes.byref(bk), ctypes.byref(st))
            bq, bk = 64, bk.value
            groups = [(label, phases, loop,
                       list(counts[g * F32_SLOTS:g * F32_SLOTS + len(phases)]))
                      for g, (label, phases, loop) in F32_GROUPS.items()]
        else:
            bq = bk = 128
            m = len(BF16_PHASES)
            groups = [(f"warpgroup {wg}", [p for _, p in BF16_PHASES],
                       range(1, 8), list(counts[wg * m:(wg + 1) * m]))
                      for wg in range(2)]
        loop = loop_tiles(bh, s, window, bq, bk)
        print(f"{name} {(bh, s, d, dv)} {args.dtype} window {window}: "
              f"{bh * -(-s // bq)} query tiles of {bq}, {loop} loop tiles "
              f"of {bk} keys")
        for label, phases, loop_phases, c in groups:
            total = sum(c)
            if not total:
                continue
            # the split kernel's CTAs take 128 query rows (64 where a row
            # has two key tiles: one multiplier)
            n = (loop_tiles(bh, s, window, 64 if -(-s // bk) == 2 else 128,
                            bk) if "_ws" in label else loop)
            per_tile = sum(c[i] for i in loop_phases) / max(n, 1)
            print(f"  {label}: {total:,} cycles; a loop tile "
                  f"{per_tile:,.0f}")
            for phase, cyc in zip(phases, c):
                print(f"    {phase:42s} {cyc:>16,} {cyc / total:7.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
