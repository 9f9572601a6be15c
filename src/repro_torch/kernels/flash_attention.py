"""Causal flash-attention forward (the prefill hot path).

:func:`flash_attention_heads` takes the models' layout: q (B, T, H, d),
k (B, T, Hkv, dk) and v (B, T, Hkv, dv) at their own kv heads (query
head h reads kv head h // (H // Hkv), as the reference's grouped
attention does), each in its own strides (a unit last stride; the
others multiples of 16 bytes, as TMA takes them), so a view such as
``q[..., :nope]`` needs no copy.  MLA's rope key, the same for every
head, comes as ``k_shared`` (B, T, rp): K's last rp columns, d = dk +
rp.  Causal, optional sliding window, scale 1/sqrt(d).  Returns (B, T,
H, dv) in q's dtype, written in that layout (``reshape(B, T, H * dv)``
is a view).  :func:`flash_attention` keeps the reference's (BH, S, d)
contract (heads flattened into the batch and any grouped-query
repetition done by the caller): the B = BH, H = Hkv = 1 case of the same
launch.

Both launch the CUDA kernel ``csrc/flash_attention.cu`` for CUDA tensors
and run a plain version for CPU tensors (:func:`attention_plain`, the
reference's ``attention_ref``, and :func:`attention_heads_plain`, the
same on K/V expanded to every query head).  Unlike the reference's
Pallas wrapper, any S works: the kernel masks the tail itself.

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
are MLA's smoke widths.  A shared key starts at a chunk of K's tile
(dk a multiple of 64 columns in bfloat16, 32 at d 32 and in float32).
Operands start on a 16-byte boundary (TMA reads them).  The kernel is
forward-only: a CUDA input that requires grad under grad mode raises
ValueError (``runtime.refuse_grad``).  :func:`tma_strides` makes every
check of a launch on tensor metadata alone, so each refusal holds before
any launch.
"""
from __future__ import annotations

import ctypes
from itertools import product

import torch

from .runtime import (CudaKernel, contiguous_strides, is_sharded,
                      map_strides, on_cuda, on_local_rows, refuse_grad,
                      require, shapes_only)

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
    [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int64)]
    + [ctypes.c_int64] * 9)


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


def attention_heads_plain(q, k, v, window=None, k_shared=None):
    """The plain version of :func:`flash_attention_heads`: the shared key
    appended to K, K and V expanded to every query head (query head h
    reads kv head h // G), the heads flattened into the batch and
    :func:`attention_plain` (so, on repeated contiguous operands, its
    output bit for bit).  Returns (B, T, H, dv)."""
    B, T, H, _ = q.shape
    G = H // k.shape[2]
    if k_shared is not None:
        k = torch.cat([k, k_shared[:, :, None].expand(
            k.shape[:3] + k_shared.shape[-1:])], -1)

    def flat(t, g):
        t = t[:, :, :, None].expand(B, T, t.shape[2], g, t.shape[-1])
        return t.permute(0, 2, 3, 1, 4).reshape(B * H, T, t.shape[-1])

    o = attention_plain(flat(q, 1), flat(k, G), flat(v, G), window)
    return o.reshape(B, H, T, -1).permute(0, 2, 1, 3)


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


def _check_window(window):
    require(window is None or int(window) >= 1,
            f"flash_attention window must be None or >= 1, got {window}")


def flash_attention(q, k, v, window=None):
    """q, k: (BH, S, d); v: (BH, S, dv); float32 or bfloat16; (d, dv) in
    :data:`BUILT` for the dtype on the GPU.  window: None or an int >= 1."""
    require(q.dim() == 3 and k.shape == q.shape and v.dim() == 3
            and v.shape[:2] == q.shape[:2],
            f"flash_attention takes (BH, S, d) q/k and (BH, S, dv) v, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _check_window(window)
    if is_sharded(q):   # every (batch, head) row on its own
        return on_local_rows(flash_attention, q, k, v, window=window)
    if shapes_only(q, k, v):
        return q.new_empty(q.shape[:2] + v.shape[2:])
    if not on_cuda(q, k, v):
        return attention_plain(q, k, v, window)
    return _launch(q[:, :, None], k[:, :, None], v[:, :, None], None,
                   window)[:, :, 0]


def flash_attention_heads(q, k, v, window=None, k_shared=None):
    """q: (B, T, H, d); k: (B, T, Hkv, dk); v: (B, T, Hkv, dv); H a
    multiple of Hkv; k_shared: None (dk == d) or (B, T, d - dk), K's last
    columns for every head (MLA's rope key).  float32 or bfloat16, (d,
    dv) in :data:`BUILT` on the GPU.  window: None or an int >= 1.
    Returns (B, T, H, dv)."""
    shared = () if k_shared is None else (k_shared,)
    require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4
            and q.shape[:2] == k.shape[:2] == v.shape[:2]
            and k.shape[2] == v.shape[2],
            f"flash_attention_heads takes (B, T, H, d) q and (B, T, Hkv, "
            f"dk) k, (B, T, Hkv, dv) v, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, d = q.shape
    Hkv = k.shape[2]
    require(Hkv >= 1 and H % Hkv == 0,
            f"flash_attention_heads: {H} query heads are not a multiple of "
            f"{Hkv} kv heads")
    rp = 0 if k_shared is None else k_shared.shape[-1]
    require(k_shared is None or (k_shared.dim() == 3
                                 and k_shared.shape[:2] == q.shape[:2]),
            f"flash_attention_heads takes a (B, T, rp) k_shared, got "
            f"{None if k_shared is None else tuple(k_shared.shape)}")
    require(k.shape[-1] + rp == d,
            f"flash_attention_heads: k's {k.shape[-1]} columns and the "
            f"shared key's {rp} do not make q's {d}")
    _check_window(window)
    if is_sharded(q):
        return _on_local_heads(q, k, v, k_shared, window)
    if shapes_only(q, k, v, *shared):
        return q.new_empty((B, T, H, v.shape[-1]))
    if not on_cuda(q, k, v, *shared):
        return attention_heads_plain(q, k, v, window, k_shared)
    return _launch(q, k, v, k_shared, window)


def _k_chunk(dtype, d) -> int:
    """The columns of a chunk of K's tile (csrc/flash_attention.cu): a
    shared key starts at one."""
    return 64 if dtype == torch.bfloat16 and d != 32 else 32


def tma_strides(q, k, v, k_shared=None) -> list:
    """Every check of a kernel launch on (B, T, H, d) operands, on their
    metadata alone, before any launch: the gradient guard, the dtype, the
    built (d, dv), the shared key's chunk, unit last strides, 16-byte
    bases and strides.  Returns the 15 strides of the launch (row, head,
    batch of q, k, v, the shared key and the (B, T, H, dv) output, in
    elements); raises ValueError for what the kernel does not take."""
    shared = () if k_shared is None else (k_shared,)
    refuse_grad("flash_attention", q, k, v, *shared)
    require(q.dtype in _DTYPES and all(t.dtype == q.dtype
                                       for t in (k, v) + shared),
            f"flash_attention kernel takes float32 or bfloat16, got "
            f"{'/'.join(str(t.dtype) for t in (q, k, v) + shared)}")
    d, dk, dv = q.shape[-1], k.shape[-1], v.shape[-1]
    require((d, dv) in BUILT[q.dtype],
            f"flash_attention kernel is not built for head dims (d, dv) = "
            f"({d}, {dv}) in {q.dtype}: it takes {sorted(BUILT[q.dtype])}")
    require(k_shared is None or dk % _k_chunk(q.dtype, d) == 0,
            f"flash_attention kernel: a shared key must start at a "
            f"{_k_chunk(q.dtype, d)}-column chunk of K, not at column {dk}")
    require(all(t.stride(-1) == 1 for t in (q, k, v) + shared),
            "flash_attention kernel operands take a unit stride in their "
            "last dim")
    require(all(t.data_ptr() % 16 == 0 for t in (q, k, v) + shared),
            "flash_attention operands must start on a 16-byte boundary "
            "(the kernel reads them with TMA)")
    B, T, H = q.shape[:3]
    out = contiguous_strides((B, T, H, dv))
    return (sum((map_strides("flash_attention", t, (1, 2, 0))
                 for t in (q, k, v)), [])
            + (map_strides("flash_attention", k_shared, (1, None, 0))
               if shared else [16 // q.element_size()] * 3)
            + [out[1] if T > 1 else 16 // q.element_size(),
               out[2] if H > 1 else 16 // q.element_size(),
               out[0] if B > 1 else 16 // q.element_size()])


def _launch(q, k, v, k_shared, window):
    strides = (ctypes.c_int64 * 15)(*tma_strides(q, k, v, k_shared))
    B, T, H, d = q.shape
    dv = v.shape[-1]
    out = torch.empty((B, T, H, dv), dtype=q.dtype, device=q.device)
    if out.numel():
        KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      None if k_shared is None else k_shared.data_ptr(),
                      out.data_ptr(), strides, B, H, k.shape[2], T, d,
                      k.shape[-1], dv, -1 if window is None else int(window),
                      _DTYPES[q.dtype])
    return out


def _on_local_heads(q, k, v, k_shared, window):
    """:func:`flash_attention_heads` on DTensor operands: each mesh dim
    keeps ``Shard(0)`` (batch rows) where q, k and v all have it, and
    ``Shard(2)`` (heads) where they all have it and the dim's size
    divides H and Hkv, so that each rank's query heads read its own kv
    heads; it is replicated otherwise (the shared key follows the batch
    rows and is whole on a head dim).  The kernel runs on each rank's
    blocks, and its output comes back as a DTensor of those placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    ops = (q, k, v)
    shared = () if k_shared is None else (k_shared,)
    require(all(isinstance(t, DTensor) and t.device_mesh == mesh
                for t in ops + shared),
            "flash_attention_heads takes DTensors on one mesh")
    H, Hkv = q.shape[2], k.shape[2]
    place, shared_place = [], []
    for j in range(mesh.ndim):
        n = mesh.size(j)
        if all(t.placements[j] == Shard(0) for t in ops):
            place.append(Shard(0))
            shared_place.append(Shard(0))
        elif (all(t.placements[j] == Shard(2) for t in ops)
              and H % n == 0 and Hkv % n == 0):
            place.append(Shard(2))
            shared_place.append(Replicate())
        else:
            place.append(Replicate())
            shared_place.append(Replicate())
    local = [t.redistribute(mesh, place).to_local() for t in ops]
    ks = (k_shared.redistribute(mesh, shared_place).to_local() if shared
          else None)
    o = flash_attention_heads(*local, window=window, k_shared=ks)
    shape = q.shape[:3] + v.shape[-1:]
    return DTensor.from_local(o.contiguous(), mesh, place, run_check=False,
                              shape=shape, stride=contiguous_strides(shape))
