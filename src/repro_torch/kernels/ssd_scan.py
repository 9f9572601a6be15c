"""Mamba2 SSD chunked scan (state-space duality), the prefill hot path.

Per row ``bh`` (batch and head flattened), state N, head dim P, chunk L:

  intra:  y_l += sum_{m<=l} exp(seg_l - seg_m) (C_l . B_m) xdt_m
  inter:  y_l += exp(seg_l) C_l . S_{c-1}
  state:  S_c  = exp(seg_last) S_{c-1}
                 + sum_m exp(seg_last - seg_m) B_m xdt_m^T

with ``seg`` the inclusive cumsum of dA within the chunk.  xdt: (BH, S, P)
= x * dt; Bh/Ch: (BH / heads_per_group, S, N), where row ``bh`` reads
row ``bh // heads_per_group`` (the model's grouped B and C, without the
repeat to every head); dA: (BH, S), <= 0.

:func:`ssd_scan` launches the CUDA kernel ``csrc/ssd_scan.cu`` for CUDA
tensors and runs :func:`ssd_scan_plain` for CPU tensors.  The kernel runs
on the tensor cores in 3xTF32 (float32 accuracy) as three passes: each
chunk's own end state, a short sequential pass over the chunks for the
state entering each, and the chunks' outputs, all chunks in parallel.
The wrapper allocates the passes' scratch, (BH, S / chunk, P, N) states
and (BH, S / chunk) decays, and frees it when the call returns.  Beyond the
reference's ``ssd_scan_pallas``, which returns y from a zero state, it
can start from a given state and return the state after the last chunk,
which the model's cache-building prefill hands to decode.
"""
from __future__ import annotations

import ctypes

import torch

from .runtime import CudaKernel, on_cuda, require

#: (P, N) pairs the kernel is built for: the reference's kernel tests,
#: the smoke configs and mamba2-370m at full width
SHAPES = ((8, 4), (16, 8), (32, 16), (64, 32), (64, 128))
MAX_CHUNK = 256

KERNEL = CudaKernel(
    "ssd_scan", "ssd_scan.cu", "ssd_scan_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 6)


def ssd_scan_plain(xdt, Bh, Ch, dA, chunk: int, heads_per_group: int = 1,
                   initial_state=None):
    """The plain PyTorch version, the chunked math in float32.  Returns
    (y in xdt's dtype, the final state (BH, N, P) float32)."""
    bh, s, p = xdt.shape
    n = Bh.shape[-1]
    nc, L = s // chunk, chunk
    x = xdt.float().reshape(bh, nc, L, p)
    B, C = (t.float()[:, None].expand(-1, heads_per_group, s, n)
            .reshape(bh, nc, L, n) for t in (Bh, Ch))
    seg = dA.float().reshape(bh, nc, L).cumsum(-1)
    causal = torch.ones(L, L, dtype=torch.bool, device=xdt.device).tril()
    decay = torch.exp((seg[..., :, None] - seg[..., None, :])
                      .masked_fill(~causal, float("-inf")))
    y = (C @ B.transpose(-1, -2) * decay) @ x            # intra-chunk
    w = torch.exp(seg[..., -1:] - seg)                    # (bh, nc, L)
    ends = (B * w[..., None]).transpose(-1, -2) @ x       # (bh, nc, N, P)
    state = (torch.zeros((bh, n, p), dtype=torch.float32, device=xdt.device)
             if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(state)
        state = torch.exp(seg[:, c, -1])[:, None, None] * state + ends[:, c]
    y = y + torch.exp(seg)[..., None] * (C @ torch.stack(prev, dim=1))
    return y.reshape(bh, s, p).to(xdt.dtype), state


def ssd_scan(xdt, Bh, Ch, dA, chunk: int, final: bool = False,
             heads_per_group: int = 1, initial_state=None):
    """y (BH, S, P), or (y, final state (BH, N, P) float32) if ``final``.
    ``initial_state``: None (zeros) or (BH, N, P).  S must be a multiple
    of ``chunk``; on the GPU chunk <= 256, float32, (P, N) in
    :data:`SHAPES`."""
    require(xdt.dim() == 3 and Bh.dim() == 3 and Ch.shape == Bh.shape
            and dA.shape == xdt.shape[:2] and heads_per_group >= 1
            and Bh.shape[0] * heads_per_group == xdt.shape[0]
            and Bh.shape[1] == xdt.shape[1],
            f"ssd_scan takes (BH, S, P) xdt, (BH / heads_per_group, S, N) "
            f"B and C and (BH, S) dA, got {tuple(xdt.shape)}, "
            f"{tuple(Bh.shape)}, {tuple(Ch.shape)}, {tuple(dA.shape)} with "
            f"heads_per_group={heads_per_group}")
    bh, s, p = xdt.shape
    n = Bh.shape[-1]
    require(s >= 1 and 1 <= chunk and s % chunk == 0,
            f"ssd_scan needs S a multiple of the chunk, got S={s}, "
            f"chunk={chunk}")
    require(initial_state is None
            or tuple(initial_state.shape) == (bh, n, p),
            f"ssd_scan initial state must be {(bh, n, p)}")
    init = () if initial_state is None else (initial_state,)
    if not on_cuda(xdt, Bh, Ch, dA, *init):
        y, state = ssd_scan_plain(xdt, Bh, Ch, dA, chunk, heads_per_group,
                                  initial_state)
        return (y, state) if final else y
    require(all(t.dtype == torch.float32 for t in (xdt, Bh, Ch, dA, *init)),
            "ssd_scan kernel takes float32")
    require(chunk <= MAX_CHUNK,
            f"ssd_scan kernel takes chunk <= {MAX_CHUNK}, got {chunk}")
    require((p, n) in SHAPES,
            f"ssd_scan kernel takes (P, N) in {SHAPES}, got {(p, n)}")
    require(all(t.is_contiguous() for t in (xdt, Bh, Ch, dA, *init)),
            "ssd_scan kernel operands must be contiguous")
    require(all(t.data_ptr() % 16 == 0 for t in (xdt, Bh, Ch)),
            "ssd_scan kernel reads xdt, B and C by TMA: their data must "
            "start on a 16-byte boundary")
    y = torch.empty_like(xdt)
    state = (torch.empty((bh, n, p), dtype=torch.float32, device=xdt.device)
             if final else None)
    nc = s // chunk
    scratch = torch.empty(bh * nc * (n * p + 1), dtype=torch.float32,
                          device=xdt.device)
    KERNEL.launch(xdt.device, xdt.data_ptr(), Bh.data_ptr(), Ch.data_ptr(),
                  dA.data_ptr(), init[0].data_ptr() if init else None,
                  y.data_ptr(), state.data_ptr() if final else None,
                  scratch.data_ptr(), bh, s, p, n, chunk, heads_per_group)
    return (y, state) if final else y
