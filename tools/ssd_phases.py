#!/usr/bin/env python3
"""Where the SSD scan's chunk_scan kernel spends its cycles, on one GPU.

    python3 tools/ssd_phases.py [--shape mamba2|zamba2] [--layout heads]

Builds a copy of ``src/repro_torch/csrc/ssd_scan.cu`` into
``build/ssd_phases/`` with ``clock64()`` read by the first thread of each
consumer warpgroup of chunk_scan at the ends of its phases, runs the scan
once at the prefill's shape (mamba2: mamba2-370m's (BH 128, S 1024, P 64,
N 128, chunk 256, 32 heads per group); zamba2: zamba2-2.7b's (BH 320,
S 1024, P 64, N 64, chunk 256, 80 heads per group)) and prints the cycles
per consumer warpgroup spent in each phase, summed over its (row, chunk)
pairs, query tiles and key tiles.  ``--layout heads`` runs the models'
layout's entry instead (x (4, S, BH / 4, P), dt folded into the kernel:
``ssd_scan_heads_launch``) on the same shape.  The phases are found by
the statements of the source (both of chunk_scan's instantiations carry
the counters); the script fails if one is missing.  The counters take
cycles themselves: read the shares more than the sum.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {"mamba2": (128, 1024, 64, 128, 256, 32),
          "zamba2": (320, 1024, 64, 64, 256, 80)}
# (anchor in the source, phase that ends there), in the order a consumer
# passes them; the key-tile phases repeat per tile (the next tile's P is
# prepared while this tile's product runs)
PHASES = [
    ("      chunk_cumsum<256>(a + (size_t)row * s + c0, chunk, 0.f, LOG2E, "
     "seg,\n                        warp_sum, ctid);",
     "pair start: both consumers, seg's cumsum"),
    ("        bar_wait<true>(bars + L::S_READY, ks & 1);",
     "C (unless loaded ahead), its split; S_prev split"),
    ("        if (z == 0 && lane == 0) bar_arrive(bars + L::S_EMPTY);",
     "C . S_prev"),
    ("        bar_wait<true>(bars + L::G_FULL + gs, (kg / GS) & 1);",
     "wait for a G tile"),
    ("        split(pa[b], pl[b]);", "G fragments, mask, decay, split"),
    ("        const int kg = k + i;\n        bar_wait<true>(bars + "
     "L::XT_FULL + (kg & 1), (kg >> 1) & 1);", "wait for x^T"),
    ("          mma3(acc, pa[b][j], pl[b][j], kdesc(xt, j, PP),\n"
     "               kdesc(xt + L::XT_BYTES, j, PP));\n        wg_commit();",
     "P . x issued"),
    ("        wg_wait_all();\n        pin(acc);\n        pin(pa[b]);\n"
     "        pin(pl[b]);", "P . x done"),
    ("      k += n_kt;", "key tiles above its rows, released"),
    ("            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);\n"
     "        }\n      }", "y stored"),
]
START = ("  for (int u = blockIdx.x; u < units; u += gridDim.x) {\n"
         "    const int row = u / nc, c = u % nc, c0 = c * chunk;\n"
         "    const int bi = row / geo.heads, hi = row - bi * geo.heads;\n"
         "    const bool inter")
END = "}\n\n// Warp specialisation in one top-level branch on the warpgroup"


def instrumented(src: str) -> str:
    def at(text, anchor, insert, before=False):
        if text.count(anchor) != 1:
            raise SystemExit(f"ssd_phases: anchor not found once: {anchor!r}")
        i = text.index(anchor) + (0 if before else len(anchor))
        return text[:i] + insert + text[i:]

    k = len(PHASES)
    src = at(src, START, f"  long long prof[{k}] = {{}}, t_ = clock64();\n",
             before=True)
    for i, (anchor, _) in enumerate(PHASES):
        src = at(src, anchor, "\n  if ((ctid & 127) == 0) { const long long "
                 f"n_ = clock64(); prof[{i}] += n_ - t_; t_ = n_; }}")
    src = at(src, END, f"  if ((ctid & 127) == 0) for (int k = 0; k < {k}; "
             "++k) atomicAdd(&g_prof[k], (unsigned long long)prof[k]);\n",
             before=True)
    return at(src, "namespace {\n", f"""__device__ unsigned long long g_prof[{k}];
extern "C" int prof_read(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}}
extern "C" int prof_zero() {{
  unsigned long long z[{k}] = {{}};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}}
""", before=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", choices=list(SHAPES), default="mamba2")
    ap.add_argument("--layout", choices=["rows", "heads"], default="rows")
    args = ap.parse_args()
    import torch

    from repro_torch.kernels import runtime
    from repro_torch.kernels.ssd_scan import launch_strides, scratch_floats
    if not torch.cuda.is_available():
        raise SystemExit("ssd_phases: no CUDA device")
    out_dir = ROOT / "build" / "ssd_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    for h in runtime.SRC_DIR.glob("*.cuh"):
        (out_dir / h.name).write_bytes(h.read_bytes())
    cu = out_dir / "ssd_scan.cu"
    cu.write_text(instrumented((runtime.SRC_DIR / "ssd_scan.cu").read_text()))
    lib = out_dir / "ssd_scan.so"
    subprocess.run([runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    fn = so.ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 6 + [
        ctypes.c_void_p]

    dev = torch.device("cuda", 0)
    bh, s, p, n, chunk, hpg = SHAPES[args.shape]
    g = torch.Generator(device=dev).manual_seed(11)
    xdt = 0.5 * torch.randn(bh, s, p, generator=g, device=dev)
    B, C = (0.5 * torch.randn(bh // hpg, s, n, generator=g, device=dev)
            for _ in range(2))
    dA = -torch.nn.functional.softplus(torch.randn(bh, s, generator=g,
                                                   device=dev))
    y = torch.empty_like(xdt)
    state = torch.empty(bh, n, p, device=dev)
    scratch = torch.empty(scratch_floats(bh, s, p, n, chunk, hpg), device=dev)

    def call():
        err = fn(xdt.data_ptr(), B.data_ptr(), C.data_ptr(), dA.data_ptr(),
                 None, y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
                 bh, s, p, n, chunk, hpg,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"ssd_phases: CUDA error {err}")

    if args.layout == "heads":   # batch 4, the rows' heads, dt separate
        heads = so.ssd_scan_heads_launch
        heads.restype = ctypes.c_int
        heads.argtypes = ([ctypes.c_void_p] * 10
                          + [ctypes.POINTER(ctypes.c_int64)]
                          + [ctypes.c_int64] * 7 + [ctypes.c_void_p])
        nb, H, G = 4, bh // 4, bh // 4 // hpg
        x = xdt.reshape(nb, H, s, p).permute(0, 2, 1, 3).contiguous()
        Bm, Cm = (t.reshape(nb, G, s, n).permute(0, 2, 1, 3).contiguous()
                  for t in (B, C))
        dt = torch.nn.functional.softplus(
            torch.randn(nb, s, H, generator=g, device=dev))
        A = -torch.linspace(0.2, 1.2, H, device=dev)
        st = (ctypes.c_int64 * 15)(*launch_strides(x, dt, A, Bm, Cm, chunk))
        yh = torch.empty_like(x)
        scratch = torch.empty(scratch_floats(bh, s, p, n, chunk, hpg,
                                             with_dt=True), device=dev)

        def call():
            err = heads(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                        dt.data_ptr(), A.data_ptr(), None, None,
                        yh.data_ptr(), state.data_ptr(), scratch.data_ptr(),
                        st, nb, s, H, G, p, n, chunk,
                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"ssd_phases: CUDA error {err}")

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    so.prof_zero()
    call()
    torch.cuda.synchronize()
    counts = (ctypes.c_ulonglong * len(PHASES))()
    so.prof_read(counts)
    units = bh * (s // chunk)
    wgs = 2 * min(units, torch.cuda.get_device_properties(dev)
                  .multi_processor_count)
    total = sum(counts)
    print(f"chunk_scan ({args.layout}) at {(bh, s, p, n)} chunk {chunk}, "
          f"heads per group {hpg}: {units} (row, chunk) pairs on "
          f"{wgs // 2} CTAs, {wgs} "
          f"consumer warpgroups; {torch.cuda.get_device_name(0)}")
    for (_, name), c in zip(PHASES, counts):
        print(f"  {name:42s} {c / wgs:9.0f} cycles per warpgroup "
              f"({100 * c / total:4.1f}%)")
    print(f"  {'total':42s} {total / wgs:9.0f} cycles per warpgroup")
    return 0


if __name__ == "__main__":
    sys.exit(main())
