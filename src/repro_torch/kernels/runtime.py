"""Build, load and dispatch for the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use (or through :func:`build`), one ``nvcc`` per
source, all started together, into ``build/repro_torch/`` at the root of
the checkout, keyed by a hash of the source, the headers and the flags.

Dispatch rule (:func:`on_cuda`): tensors on a CUDA device launch the
kernel, or raise; tensors on the CPU take the plain PyTorch version.
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Every kernel of the port by name (``launch_counts`` reads them).
KERNELS: dict = {}
_LIBS: dict = {}   # source file name -> loaded ctypes library


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def _target(source: str) -> Path:
    """The library's path, keyed by the source, every header of csrc/
    (a source may include any of them) and the flags."""
    text = (SRC_DIR / source).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources=None) -> dict:
    """Compile every source whose library is missing, in parallel, and
    load them all.  Returns ``{source: seconds}`` for what was compiled.
    Raises with nvcc's output if a compile fails."""
    sources = sorted(sources or {k.source for k in KERNELS.values()})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = _target(src)
        if src in _LIBS or out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT),
                      tmp, out, log, time.perf_counter())
    times, failed = {}, []
    for src, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        times[src] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{src} (rc {rc}):\n"
                          + out.with_suffix(".log").read_text())
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for src in sources:
        if src not in _LIBS:
            _LIBS[src] = ctypes.CDLL(str(_target(src)))
    return times


class CudaKernel:
    """One hand-written kernel: its source, its C entry point (returning
    ``cudaGetLastError()``) and a plain count of its launches."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def _entry(self):
        if self._fn is None:
            if self.source not in _LIBS:
                build([self.source])
            fn = getattr(_LIBS[self.source], self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; ``args`` are pointers
        (``data_ptr()``) and sizes, in the order of ``argtypes``."""
        fn = self._entry()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"kernel {self.name}: CUDA error {err}")
        self.launches += 1


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts[name]`` launches to each named kernel.
    A CUDA graph's replay runs the launches captured in it without the
    wrappers: its owner (``core/graphs.py``) counts them here, and takes
    the capture's own (recorded, not run) back out with ``times=-1``."""
    for name, n in counts.items():
        KERNELS[name].launches += n * times


def on_cuda(*tensors) -> bool:
    """The dispatch rule: True if every tensor lies on one CUDA device
    (launch the kernel), False if all lie on the CPU (plain version).
    Anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {dev}")


def require(cond: bool, msg: str) -> None:
    """A wrapper's argument check: raise ValueError unless ``cond``."""
    if not cond:
        raise ValueError(msg)
