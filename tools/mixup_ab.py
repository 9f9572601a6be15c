#!/usr/bin/env python3
"""The Mixup kernel (B1) of two checkouts of the port, in turns, on one
GPU.

    python3 tools/mixup_ab.py OTHER_CHECKOUT

Builds ``src/repro_torch/csrc/mixup.cu`` of OTHER_CHECKOUT and of this
checkout with nvcc (the port's flags) into ``build/mixup_ab/``, checks
that both give the plain version's result bit for bit, then times each
at the round loop's rows (100, 784), the cifar rows (100, 3072) and the
speech rows (100, 1280), float32: device time per launch (20 launches in
one CUDA graph, median of 20 replays, CUDA events), in turns: other,
this, this, other, three times.  Prints the medians and the ratio
this / other per shape, and ``torch.lerp``'s time beside them.  Needs a
CUDA GPU.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

THIS = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(THIS / "src"))
sys.path.insert(0, str(THIS))

SHAPES = ((100, 784), (100, 3072), (100, 1280))


def build(checkout: Path, name: str):
    """One checkout's mixup.cu as a ctypes library."""
    from repro_torch.kernels import runtime

    out = THIS / "build" / "mixup_ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", str(out),
                    str(checkout / "src/repro_torch/csrc/mixup.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).mixup_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    return fn


def launcher(fn, a, b, la, lb, out):
    n, f = a.shape

    def call():
        err = fn(a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
                 out.data_ptr(), n, f, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mixup_launch: CUDA error {err}")
    return call


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from chip_smoke import device_ms, nvidia_smi
    from repro_torch.kernels.mixup_kernel import mixup_plain

    libs = {"other": build(Path(sys.argv[1]).resolve(), "other"),
            "this": build(THIS, "this")}
    print(nvidia_smi())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, f in SHAPES:
        a, b = (torch.rand(n, f, generator=gen, device="cuda")
                for _ in range(2))
        la = torch.full((n,), 0.1, device="cuda")
        lb = 1.0 - la
        want = mixup_plain(a, b, la, lb)
        calls = {}
        for name, fn in libs.items():
            out = torch.empty_like(a)
            calls[name] = launcher(fn, a, b, la, lb, out)
            calls[name]()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"{name} ({n}, {f}): not bit-equal")
        times = {"other": [], "this": []}
        for _ in range(3):
            for name in ("other", "this", "this", "other"):
                times[name].append(device_ms(calls[name]))
        lerp = device_ms(lambda: torch.lerp(b, a, la[:, None]))
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"mixup ({n}, {f}) float32: other "
              f"{[round(t, 6) for t in times['other']]} ms, this "
              f"{[round(t, 6) for t in times['this']]} ms; medians "
              f"{med['other']:.6f} / {med['this']:.6f} ms, this/other "
              f"{med['this'] / med['other']:.3f}; torch.lerp {lerp:.6f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
