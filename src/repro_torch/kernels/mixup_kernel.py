"""Two-way Mixup batch transform (eq. 6 / 7).

out[i] = lam_a[i] * a[i] + lam_b[i] * b[i]

covers both device-side Mixup (lam, 1-lam) and server-side inverse-Mixup
(lam_hat, 1-lam_hat, extrapolating ratios).  ``mixup`` launches the CUDA
kernel ``csrc/mixup.cu`` for CUDA tensors and runs :func:`mixup_plain`
for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from .runtime import CudaKernel, on_cuda, require

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel(
    "mixup", "mixup.cu", "mixup_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3)


def mixup_plain(a, b, lam_a, lam_b):
    """The plain PyTorch version: float32 ratios, output in a's dtype."""
    la = lam_a.to(torch.float32)[:, None]
    lb = lam_b.to(torch.float32)[:, None]
    return (la * a.to(torch.float32) + lb * b.to(torch.float32)).to(a.dtype)


def mixup(a, b, lam_a, lam_b):
    """a, b: (N, F) float32 or bfloat16; lam_a, lam_b: (N,) float32.
    Returns (N, F) in a's dtype."""
    require(a.dim() == 2 and a.shape == b.shape,
            f"mixup takes two (N, F) operands, got {tuple(a.shape)} and "
            f"{tuple(b.shape)}")
    require(lam_a.shape == (a.shape[0],) and lam_b.shape == lam_a.shape,
            "mixup ratios must be (N,)")
    if not on_cuda(a, b, lam_a, lam_b):
        return mixup_plain(a, b, lam_a, lam_b)
    require(a.dtype in _DTYPES and b.dtype == a.dtype,
            f"mixup kernel takes float32 or bfloat16, got {a.dtype}/"
            f"{b.dtype}")
    require(lam_a.dtype == torch.float32 and lam_b.dtype == torch.float32,
            "mixup kernel ratios must be float32")
    require(all(t.is_contiguous() for t in (a, b, lam_a, lam_b)),
            "mixup kernel operands must be contiguous")
    out = torch.empty_like(a)
    n, f = a.shape
    if out.numel():
        KERNEL.launch(a.device, a.data_ptr(), b.data_ptr(),
                      lam_a.data_ptr(), lam_b.data_ptr(), out.data_ptr(),
                      n, f, _DTYPES[a.dtype])
    return out
