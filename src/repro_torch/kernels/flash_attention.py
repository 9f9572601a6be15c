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
float32 smoke configs' logits within ~1e-6 of the CPU's).  The head dims
are :data:`HEAD_DIMS`, and on the CUDA cores also 16 (the transformer
classifier's, :data:`F32_HEAD_DIMS`); on the tensor cores a dim of 80
(zamba2), 96 (phi3-mini) or 120 (h2o-danube3) runs in the 128-column
tile with its columns d-127 loaded as zeros.  On the CUDA cores 96 and
120 take dv == d only (:data:`F32_SQUARE_DIMS`).  The kernel is
forward-only: a CUDA input that requires grad under grad mode raises
ValueError (``runtime.refuse_grad``).
"""
from __future__ import annotations

import ctypes

import torch

from .runtime import CudaKernel, on_cuda, refuse_grad, require

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 96, 120, 128)
F32_HEAD_DIMS = (16,) + HEAD_DIMS
F32_SQUARE_DIMS = (96, 120)   # float32: built for dv == d only

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


BF16_REL = 2.0 ** -7     # one bf16 ulp of |o| at most: both sides round o
BF16_ROW_FLOOR = 2.0 ** -5   # of the row's rms: p's bf16 rounding


def bf16_excess(got, want) -> float:
    """The largest ``|got - want| / (BF16_REL * |want| + BF16_ROW_FLOOR *
    rms(want's row))`` over the elements of a bf16 output against the
    plain version: at most 1 where the two agree.  The kernel rounds p
    from the running max and the plain version from the row's, so their
    difference scales with the row (an output of many keys is small) and
    not with a fixed bound."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    return float(((g - w).abs()
                  / (BF16_REL * w.abs() + BF16_ROW_FLOOR * rms + 1e-30))
                 .max())


def flash_attention(q, k, v, window=None):
    """q, k: (BH, S, d); v: (BH, S, dv); float32 or bfloat16; d and dv
    in :data:`HEAD_DIMS` on the GPU (:data:`F32_HEAD_DIMS` in float32).
    window: None or an int >= 1."""
    require(q.dim() == 3 and k.shape == q.shape and v.dim() == 3
            and v.shape[:2] == q.shape[:2],
            f"flash_attention takes (BH, S, d) q/k and (BH, S, dv) v, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    require(window is None or int(window) >= 1,
            f"flash_attention window must be None or >= 1, got {window}")
    if not on_cuda(q, k, v):
        return attention_plain(q, k, v, window)
    refuse_grad("flash_attention", q, k, v)
    require(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
            f"flash_attention kernel takes float32 or bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    bh, s, d = q.shape
    dv = v.shape[-1]
    dims = F32_HEAD_DIMS if q.dtype == torch.float32 else HEAD_DIMS
    require(d in dims and dv in dims,
            f"flash_attention kernel takes head dims {dims} in {q.dtype}, "
            f"got d={d}, dv={dv}")
    require(q.dtype != torch.float32 or d == dv
            or not {d, dv} & set(F32_SQUARE_DIMS),
            f"flash_attention float32 kernel takes head dims "
            f"{F32_SQUARE_DIMS} with dv == d only, got d={d}, dv={dv}")
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
