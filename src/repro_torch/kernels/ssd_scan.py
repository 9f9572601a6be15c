"""Mamba2 SSD chunked scan (state-space duality), the prefill hot path.

Per row ``bh`` (batch and head flattened), state N, head dim P, chunk L:

  intra:  y_l += sum_{m<=l} exp(seg_l - seg_m) (C_l . B_m) xdt_m
  inter:  y_l += exp(seg_l) C_l . S_{c-1}
  state:  S_c  = exp(seg_last) S_{c-1}
                 + sum_m exp(seg_last - seg_m) B_m xdt_m^T

with ``seg`` the inclusive cumsum of dA within the chunk and xdt = x * dt.

:func:`ssd_scan_heads` takes the models' layout: x (B, S, H, P), dt (B,
S, H), A (H,), B and C (B, S, G, N), head h reading group h // (H // G)
(the model's grouped B and C, without the repeat to every head), each in
its own strides (a unit last stride; the others multiples of 16 bytes
where TMA reads them), so the mixer's views of its projection need no
copy.  dt is folded into the kernel's per-key scales (xdt_m = dt_m x_m
enters each key's decayed score and its state weight) and dA = dt A_h is
formed where the kernel's cumsum reads it: no x * dt tensor exists.  It
returns y (B, S, H, P), written in that layout (``reshape(B, S, H * P)``
is a view).  :func:`ssd_scan` keeps the reference's contract: xdt (BH, S,
P), Bh/Ch (BH / heads_per_group, S, N), row ``bh`` reading row ``bh //
heads_per_group``, dA (BH, S), <= 0 — the B = 1, H = BH case of the same
launch, without dt.

Both launch the CUDA kernel ``csrc/ssd_scan.cu`` for CUDA tensors and run
a plain version for CPU tensors (:func:`ssd_scan_plain`, and
:func:`ssd_scan_heads_plain`: the rows, x * dt and ``ssd_scan_plain``).
The kernel runs on the tensor cores in 3xTF32 (float32 accuracy) as four
passes: the scores C . B^T of each B/C group's causal 64 x 64 tiles (once
for the group's heads), each chunk's own end state, a short sequential
pass over the chunks for the state entering each, and the chunks'
outputs, all chunks in parallel.  The wrapper allocates the passes'
scratch (:func:`scratch_floats`: (BH, S / chunk, P, N) states, the score
tiles, (BH, S / chunk) decays and, with dt, a copy of dt by chunk) and
frees it when the call returns.  Beyond the reference's
``ssd_scan_pallas``, which returns y from a zero state, it can start from
a given state and return the state after the last chunk, which the
model's cache-building prefill hands to decode.  The kernel is
forward-only: a CUDA input that requires grad under grad mode raises
ValueError (``runtime.refuse_grad``).  :func:`launch_strides` makes every
check of a models'-layout launch on tensor metadata alone, so each
refusal holds before any launch; on the meta device (the dry run) the
entry allocates what the launch would (y, the state, the scratch) and
computes nothing.
"""
from __future__ import annotations

import ctypes

import torch

from .runtime import (CudaKernel, contiguous_strides, map_strides, on_cuda,
                      refuse_grad, require, shapes_only)

#: (P, N) pairs the kernel is built for: the reference's kernel tests,
#: the smoke configs, mamba2-370m and zamba2-2.7b at full width
SHAPES = ((8, 4), (16, 8), (32, 16), (64, 32), (64, 64), (64, 128))
MAX_CHUNK = 256

KERNEL = CudaKernel(
    "ssd_scan", "ssd_scan.cu", "ssd_scan_heads_launch",
    [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_int64)]
    + [ctypes.c_int64] * 7)


def scratch_floats(bh: int, s: int, p: int, n: int, chunk: int,
                   heads_per_group: int = 1, with_dt: bool = False) -> int:
    """Floats of the kernel's scratch: each chunk's state (BH, S / chunk,
    P, N) and decay (BH, S / chunk), each group's causal 64 x 64 score
    tiles, q (q + 1) / 2 a chunk of q = ceil(chunk / 64) query tiles, and
    ``with_dt`` the chunks' dt, 64 q floats a (row, chunk)."""
    nc, q = s // chunk, -(-chunk // 64)
    return (bh * nc * (n * p + 1)
            + bh // heads_per_group * nc * q * (q + 1) // 2 * 64 * 64
            + (bh * nc * 64 * q if with_dt else 0))


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
    if shapes_only(xdt, Bh, Ch, dA, *init):
        y = xdt.new_empty(xdt.shape)
        return (y, xdt.new_empty((bh, n, p), dtype=torch.float32)) \
            if final else y
    if not on_cuda(xdt, Bh, Ch, dA, *init):
        y, state = ssd_scan_plain(xdt, Bh, Ch, dA, chunk, heads_per_group,
                                  initial_state)
        return (y, state) if final else y
    refuse_grad("ssd_scan", xdt, Bh, Ch, dA, *init)
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
    # (BH, S, P) rows: batch 1, BH heads, BH / heads_per_group groups
    _launch(xdt, Bh, Ch, None, None, dA, init[0] if init else None, y,
            state, scratch_floats(bh, s, p, n, chunk, heads_per_group),
            [p, s * p, 4, n, s * n, 4, n, s * n, 4, 0, 0, 0, p, s * p, 4],
            1, s, bh, bh // heads_per_group, p, n, chunk)
    return (y, state) if final else y


def _launch(x, Bm, Cm, dt, A, dA, init, y, state, floats, strides, batch,
            s, heads, groups, p, n, chunk):
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    KERNEL.launch(x.device, x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                  None if dt is None else dt.data_ptr(),
                  None if A is None else A.data_ptr(),
                  None if dA is None else dA.data_ptr(),
                  None if init is None else init.data_ptr(), y.data_ptr(),
                  None if state is None else state.data_ptr(),
                  scratch.data_ptr(), (ctypes.c_int64 * 15)(*strides), batch,
                  s, heads, groups, p, n, chunk)


def ssd_scan_heads_plain(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """The plain version of :func:`ssd_scan_heads`: the heads flattened
    into rows, xdt = x * dt and dA = dt * A formed in float32, and
    :func:`ssd_scan_plain` with B and C per group.  Returns (y (B, S, H,
    P), the final state (B, H, N, P) float32)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]

    def rows(t):   # (B, S, X, Y) -> (B * X, S, Y)
        return t.permute(0, 2, 1, 3).reshape(-1, S, t.shape[-1])

    dtf = dt.float()
    init = (None if initial_state is None
            else initial_state.reshape(B * H, N, P))
    y, state = ssd_scan_plain(
        rows(x.float() * dtf[..., None]), rows(Bm), rows(Cm),
        (dtf * A.float()).permute(0, 2, 1).reshape(B * H, S), chunk, H // G,
        init)
    return (y.reshape(B, H, S, P).permute(0, 2, 1, 3).to(x.dtype),
            state.reshape(B, H, N, P))


def launch_strides(x, dt, A, Bm, Cm, chunk: int, initial_state=None) -> list:
    """Every check of a kernel launch on (B, S, H, P) operands, on their
    metadata alone, before any launch: the gradient guard, float32, the
    built (P, N), the chunk, unit last strides, 16-byte bases and TMA's
    strides of x, B and C, a contiguous A and initial state.  Returns the
    15 element strides of the launch ((t, head or group, batch) of x, B,
    C, dt and the (B, S, H, P) output); raises ValueError for what the
    kernel does not take."""
    init = () if initial_state is None else (initial_state,)
    refuse_grad("ssd_scan", x, dt, A, Bm, Cm, *init)
    require(all(t.dtype == torch.float32 for t in (x, dt, A, Bm, Cm, *init)),
            "ssd_scan kernel takes float32")
    P, N = x.shape[-1], Bm.shape[-1]
    require((P, N) in SHAPES,
            f"ssd_scan kernel takes (P, N) in {SHAPES}, got {(P, N)}")
    require(chunk <= MAX_CHUNK,
            f"ssd_scan kernel takes chunk <= {MAX_CHUNK}, got {chunk}")
    require(all(t.stride(-1) == 1 or t.shape[-1] == 1 for t in (x, Bm, Cm)),
            "ssd_scan kernel operands x, B and C take a unit stride in "
            "their last dim")
    require(all(t.data_ptr() % 16 == 0 for t in (x, Bm, Cm)),
            "ssd_scan kernel reads x, B and C by TMA: their data must "
            "start on a 16-byte boundary")
    require(all(st >= 0 for st in dt.stride()),
            "ssd_scan kernel takes dt with non-negative strides")
    require(A.is_contiguous() and all(t.is_contiguous() for t in init),
            "ssd_scan kernel takes a contiguous A and initial state")
    out = contiguous_strides(x.shape)
    return (sum((map_strides("ssd_scan", t, (1, 2, 0)) for t in (x, Bm, Cm)),
                [])
            + [dt.stride(1), dt.stride(2), dt.stride(0), out[1], out[2],
               out[0]])


def ssd_scan_heads(x, dt, A, Bm, Cm, chunk: int, initial_state=None,
                   final: bool = False):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm: (B, S, G, N) with
    H a multiple of G; ``initial_state``: None (zeros) or (B, H, N, P).
    Returns y (B, S, H, P), or (y, final state (B, H, N, P) float32) if
    ``final``.  S must be a multiple of ``chunk``; on the GPU chunk <=
    256, float32, (P, N) in :data:`SHAPES` and the strides
    :func:`launch_strides` takes."""
    require(x.dim() == 4 and dt.shape == x.shape[:3] and A.dim() == 1
            and A.shape[0] == x.shape[2] and Bm.dim() == 4
            and Cm.shape == Bm.shape and Bm.shape[:2] == x.shape[:2],
            f"ssd_scan_heads takes (B, S, H, P) x, (B, S, H) dt, (H,) A and "
            f"(B, S, G, N) B and C, got {tuple(x.shape)}, "
            f"{tuple(dt.shape)}, {tuple(A.shape)}, {tuple(Bm.shape)}, "
            f"{tuple(Cm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    require(G >= 1 and H % G == 0,
            f"ssd_scan_heads: {H} heads are not a multiple of {G} groups")
    require(S >= 1 and 1 <= chunk and S % chunk == 0,
            f"ssd_scan needs S a multiple of the chunk, got S={S}, "
            f"chunk={chunk}")
    require(initial_state is None
            or tuple(initial_state.shape) == (B, H, N, P),
            f"ssd_scan_heads initial state must be {(B, H, N, P)}")
    init = () if initial_state is None else (initial_state,)
    floats = scratch_floats(B * H, S, P, N, chunk, H // G, with_dt=True)
    if shapes_only(x, dt, A, Bm, Cm, *init):
        # what a launch allocates: y, the state and, for the call, the
        # scratch
        y = x.new_empty((B, S, H, P))
        state = (x.new_empty((B, H, N, P), dtype=torch.float32) if final
                 else None)
        x.new_empty((floats,), dtype=torch.float32)
        return (y, state) if final else y
    if not on_cuda(x, dt, A, Bm, Cm, *init):
        y, state = ssd_scan_heads_plain(x, dt, A, Bm, Cm, chunk,
                                        initial_state)
        return (y, state) if final else y
    strides = launch_strides(x, dt, A, Bm, Cm, chunk, initial_state)
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    state = (torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
             if final else None)
    if y.numel():
        _launch(x, Bm, Cm, dt, A, None, initial_state, y, state, floats,
                strides, B, S, H, G, P, N, chunk)
    return (y, state) if final else y
