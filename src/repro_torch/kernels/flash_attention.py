"""Causal flash-attention forward (the prefill hot path).

q, k, v: (BH, S, d) with the heads flattened into the batch axis and any
grouped-query repetition done by the caller; causal, optional sliding
window, scale 1/sqrt(d).  Returns (BH, S, dv) in q's dtype.

:func:`flash_attention` launches the CUDA kernel ``csrc/flash_attention.cu``
for CUDA tensors and runs :func:`attention_plain` (the reference's
``attention_ref``) for CPU tensors.  Unlike the reference's Pallas
wrapper, any S works: the kernel masks the tail itself.

On the GPU the dtype picks the route inside the same entry point:
bfloat16 runs on the tensor cores (wgmma, K/V tiles by TMA), float32 on
the CUDA cores in full float32 (a TF32 product would not keep the
float32 smoke configs' logits within ~1e-6 of the CPU's).
"""
from __future__ import annotations

import ctypes

import torch

from .runtime import CudaKernel, on_cuda, require

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)

KERNEL = CudaKernel(
    "flash_attention", "flash_attention.cu", "flash_attention_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6)


def attention_plain(q, k, v, window=None):
    """The plain PyTorch version: float32 scores, a full softmax, the
    probabilities cast to v's dtype before the product with V."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (
        q.shape[-1] ** 0.5)
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v).to(q.dtype)


def flash_attention(q, k, v, window=None):
    """q, k: (BH, S, d); v: (BH, S, dv); float32 or bfloat16; d and dv
    in (32, 64, 128) on the GPU.  window: None or an int >= 1."""
    require(q.dim() == 3 and k.shape == q.shape and v.dim() == 3
            and v.shape[:2] == q.shape[:2],
            f"flash_attention takes (BH, S, d) q/k and (BH, S, dv) v, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    require(window is None or int(window) >= 1,
            f"flash_attention window must be None or >= 1, got {window}")
    if not on_cuda(q, k, v):
        return attention_plain(q, k, v, window)
    require(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
            f"flash_attention kernel takes float32 or bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    bh, s, d = q.shape
    dv = v.shape[-1]
    require(d in HEAD_DIMS and dv in HEAD_DIMS,
            f"flash_attention kernel takes head dims {HEAD_DIMS}, got "
            f"d={d}, dv={dv}")
    require(all(t.is_contiguous() for t in (q, k, v)),
            "flash_attention kernel operands must be contiguous")
    require(q.dtype != torch.bfloat16
            or all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
            "flash_attention bfloat16 operands must start on a 16-byte "
            "boundary (the kernel reads them with TMA)")
    out = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    if out.numel():
        KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), bh, s, d, dv,
                      -1 if window is None else int(window),
                      _DTYPES[q.dtype])
    return out
