"""Causal flash-attention forward (the prefill hot path).

q, k, v: (BH, S, d) with the heads flattened into the batch axis and any
grouped-query repetition done by the caller; causal, optional sliding
window, scale 1/sqrt(d).  Returns (BH, S, dv) in q's dtype.

:func:`flash_attention` launches the CUDA kernel ``csrc/flash_attention.cu``
for CUDA tensors and runs :func:`attention_plain` (the reference's
``attention_ref``) for CPU tensors.  Unlike the reference's Pallas
wrapper, any S works: the kernel masks the tail itself.

On the GPU both dtypes run on the tensor cores (wgmma, K/V tiles by
TMA), the route picked by dtype inside the same entry point.  bfloat16
rounds p to bfloat16 before p.V; float32 keeps float32 accuracy in
3xTF32: each operand a is split into trunc(a) (what TF32 reads) and
a - trunc(a), and three products go into float32 accumulators, so the
float32 smoke configs' logits stay within ~1e-6 of the CPU's (one TF32
product keeps ~3 decimal digits and misses that).  The (d, dv) pairs
each route is built for are :data:`BUILT`; any other pair raises
ValueError before a launch.  On the bfloat16 route a dim of 80 (zamba2),
96 (phi3-mini) or 120 (h2o-danube3) runs in the 128-column tile with its
columns d-127 loaded as zeros, and MLA's (192, 128) (deepseek-v2) has an
instantiation of its own.  On the float32 route 96 and 120 take dv == d
only, 16 is the transformer classifier's, and (48, 32) and (192, 128)
are MLA's smoke widths.  Operands start on a 16-byte boundary (TMA
reads them).  The kernel is forward-only: a CUDA input that requires
grad under grad mode raises ValueError (``runtime.refuse_grad``).
"""
from __future__ import annotations

import ctypes
from itertools import product

import torch

from .runtime import (CudaKernel, is_sharded, on_cuda, on_local_rows,
                      refuse_grad, require, shapes_only)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILED = (32, 64, 80, 96, 120, 128)   # the tensor-core tiles' head dims
# (d, dv) pairs built for each dtype, as csrc/flash_attention.cu's
# launch_d dispatches them (flash_attention_layout reports the bfloat16
# ones)
BUILT = {
    torch.bfloat16: frozenset(product(_TILED, _TILED)) | {(192, 128)},
    torch.float32: frozenset(product((16, 32, 64, 80, 128), repeat=2))
    | {(96, 96), (120, 120), (48, 32), (192, 128)},
}

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
    """q, k: (BH, S, d); v: (BH, S, dv); float32 or bfloat16; (d, dv) in
    :data:`BUILT` for the dtype on the GPU.  window: None or an int >= 1."""
    require(q.dim() == 3 and k.shape == q.shape and v.dim() == 3
            and v.shape[:2] == q.shape[:2],
            f"flash_attention takes (BH, S, d) q/k and (BH, S, dv) v, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    require(window is None or int(window) >= 1,
            f"flash_attention window must be None or >= 1, got {window}")
    if is_sharded(q):   # every (batch, head) row on its own
        return on_local_rows(flash_attention, q, k, v, window=window)
    if shapes_only(q, k, v):
        return q.new_empty(q.shape[:2] + v.shape[2:])
    if not on_cuda(q, k, v):
        return attention_plain(q, k, v, window)
    refuse_grad("flash_attention", q, k, v)
    require(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
            f"flash_attention kernel takes float32 or bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    bh, s, d = q.shape
    dv = v.shape[-1]
    require((d, dv) in BUILT[q.dtype],
            f"flash_attention kernel is not built for head dims (d, dv) = "
            f"({d}, {dv}) in {q.dtype}: it takes {sorted(BUILT[q.dtype])}")
    require(all(t.is_contiguous() for t in (q, k, v)),
            "flash_attention kernel operands must be contiguous")
    require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
            "flash_attention operands must start on a 16-byte boundary "
            "(the kernel reads them with TMA)")
    out = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    if out.numel():
        KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), bh, s, d, dv,
                      -1 if window is None else int(window),
                      _DTYPES[q.dtype])
    return out
