#!/usr/bin/env python3
"""Where the SSD scan's chunk_scan kernel spends its cycles, on one GPU.

    python3 tools/ssd_phases.py

Builds a copy of ``src/repro_torch/csrc/ssd_scan.cu`` into
``build/ssd_phases/`` with ``clock64()`` read by the first thread of each
warpgroup of chunk_scan at the ends of its phases, runs the scan once at
the mamba2-370m prefill's shape (BH 128, S 1024, P 64, N 128, chunk 256,
32 heads per group) and prints the cycles per warpgroup spent in each
phase, summed over its key tiles.  The phases are found by the comments
and statements of the source; the script fails if one is missing.  The
counters take cycles themselves: read the shares more than the sum.
Needs a CUDA GPU.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (anchor in the source, phase that ends there)
PHASES = [
    ("  bar_wait(c_full, 0);", "start: C loaded, seg's cumsum"),
    ("  consumer_sync<NC>();  // C and S_prev are read: regions 0 and u "
     "are free", "C fragments, S_prev split, C . S_prev"),
    ("  bar_wait(full, 0);\n  split_b(0);\n  split_x(0);\n  fence_async();\n"
     "  consumer_sync<NC>();", "tile 0 split"),
    ("    wg_commit();\n    if (next) {", "C . B^T issued"),
    ("    consumer_sync<NC>();  // every C . B^T is done: B small is free",
     "x^T of the next tile, C . B^T done"),
    ("    split(pa, pl);", "mask and decay"),
    ("    consumer_sync<NC>();  // x^T of tile i is free; tile i + 1 is split",
     "P . x and B small of the next tile"),
]
START = "  // seg in log2 units: every exponential below is one ex2"
END = ("#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n"
       "    const int l = l0 + 8 * h;\n    if (l >= chunk) continue;")


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
        src = at(src, anchor, "\n  if ((tid & 127) == 0) { const long long "
                 f"n_ = clock64(); prof[{i}] += n_ - t_; t_ = n_; }}")
    src = at(src, END, f"  if ((tid & 127) == 0) for (int k = 0; k < {k}; "
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
    import torch

    from repro_torch.kernels import runtime
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
    bh, s, p, n, chunk, hpg = 128, 1024, 64, 128, 256, 32
    g = torch.Generator(device=dev).manual_seed(11)
    xdt = 0.5 * torch.randn(bh, s, p, generator=g, device=dev)
    B, C = (0.5 * torch.randn(bh // hpg, s, n, generator=g, device=dev)
            for _ in range(2))
    dA = -torch.nn.functional.softplus(torch.randn(bh, s, generator=g,
                                                   device=dev))
    y = torch.empty_like(xdt)
    state = torch.empty(bh, n, p, device=dev)
    scratch = torch.empty(bh * (s // chunk) * (n * p + 1), device=dev)

    def call():
        err = fn(xdt.data_ptr(), B.data_ptr(), C.data_ptr(), dA.data_ptr(),
                 None, y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
                 bh, s, p, n, chunk, hpg,
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
    wgs = 2 * bh * (s // chunk) * ((chunk + 127) // 128)
    total = sum(counts)
    print(f"chunk_scan at {(bh, s, p, n)} chunk {chunk}, {wgs} warpgroups; "
          f"{torch.cuda.get_device_name(0)}")
    for (_, name), c in zip(PHASES, counts):
        print(f"  {name:42s} {c / wgs:9.0f} cycles per warpgroup "
              f"({100 * c / total:4.1f}%)")
    print(f"  {'total':42s} {total / wgs:9.0f} cycles per warpgroup")
    return 0


if __name__ == "__main__":
    sys.exit(main())
