"""Per-sample distillation terms of eq. (3) and their backward.

Per sample i with logits z_i (C classes), label y_i and KD target row
g_i (the G_out row of y_i's ground truth):

  phi_i = logsumexp(z_i) - z_i[y_i]
  psi_i = sum_c g_ic * (logsumexp(z_i) - z_ic)

:func:`distill_phi_psi` is a ``torch.autograd.Function`` whose forward
and backward are the CUDA kernels of ``csrc/distill.cu`` for CUDA
tensors, and :func:`phi_psi_plain` / :func:`phi_psi_bwd_plain` for CPU
tensors.  psi carries the exact ``sum(g) * lse`` term, so it matches the
KD regularizer for unnormalised and zero G_out rows too.

:func:`distill_loss` is the reference's fused forward-only
``phi + beta * (lse - g . z)`` (it assumes rows of g sum to 1, as G_out
rows do): the third kernel of ``csrc/distill.cu`` on the GPU,
:func:`distill_loss_plain` on the CPU.  It has no gradient, as the
reference kernel has none.
"""
from __future__ import annotations

import ctypes

import torch

from .runtime import CudaKernel, on_cuda, require

FWD = CudaKernel("distill_fwd", "distill.cu", "phi_psi_fwd_launch",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2)
BWD = CudaKernel("distill_bwd", "distill.cu", "phi_psi_bwd_launch",
                 [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 2)


LOSS = CudaKernel("distill_loss", "distill.cu", "distill_loss_launch",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
                  + [ctypes.c_float])


def _work_dtype(t):
    # float64 stays float64 (gradcheck); everything else runs in float32
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def phi_psi_plain(z, y, g):
    """Plain forward: z (N, C), y (N,) int, g (N, C) -> phi, psi (N,)."""
    dt = _work_dtype(z)
    z, g = z.to(dt), g.to(dt)
    lse = torch.logsumexp(z, dim=-1)
    onehot = torch.nn.functional.one_hot(y, z.shape[-1]).to(torch.bool)
    zy = torch.where(onehot, z, 0.0).sum(-1)
    return lse - zy, g.sum(-1) * lse - (g * z).sum(-1)


def phi_psi_bwd_plain(z, y, g, dphi, dpsi):
    """Plain backward: returns (dz, dg), both (N, C)."""
    dt = _work_dtype(z)
    z, g = z.to(dt), g.to(dt)
    dphi, dpsi = dphi.to(dt)[:, None], dpsi.to(dt)[:, None]
    m = z.amax(-1, keepdim=True)
    e = torch.exp(z - m)
    s = e.sum(-1, keepdim=True)
    lse = torch.log(s) + m
    p = e / s
    onehot = torch.nn.functional.one_hot(y, z.shape[-1]).to(dt)
    sg = g.sum(-1, keepdim=True)
    return dphi * (p - onehot) + dpsi * (sg * p - g), dpsi * (lse - z)


def _check(z, y, g, *rows):
    require(z.dim() == 2 and g.shape == z.shape,
            f"distill kernel takes (N, C) logits and targets, got "
            f"{tuple(z.shape)} and {tuple(g.shape)}")
    require(y.shape == (z.shape[0],) and y.dtype == torch.int64,
            f"distill kernel labels must be (N,) int64, got "
            f"{tuple(y.shape)} {y.dtype}")
    require(all(t.dtype == torch.float32 for t in (z, g) + rows),
            "distill kernel takes float32 logits, targets and cotangents")
    require(all(t.is_contiguous() for t in (z, y, g) + rows),
            "distill kernel operands must be contiguous")
    require(all(t.shape == (z.shape[0],) for t in rows),
            "distill kernel cotangents must be (N,)")


def phi_psi_fwd(z, y, g):
    """Forward dispatch: the CUDA kernel or :func:`phi_psi_plain`."""
    if not on_cuda(z, y, g):
        return phi_psi_plain(z, y, g)
    _check(z, y, g)
    n, c = z.shape
    phi = torch.empty(n, dtype=torch.float32, device=z.device)
    psi = torch.empty_like(phi)
    if n:
        FWD.launch(z.device, z.data_ptr(), y.data_ptr(), g.data_ptr(),
                   phi.data_ptr(), psi.data_ptr(), n, c)
    return phi, psi


def phi_psi_bwd(z, y, g, dphi, dpsi):
    """Backward dispatch: the CUDA kernel or :func:`phi_psi_bwd_plain`."""
    if not on_cuda(z, y, g, dphi, dpsi):
        return phi_psi_bwd_plain(z, y, g, dphi, dpsi)
    dphi, dpsi = dphi.contiguous(), dpsi.contiguous()
    _check(z, y, g, dphi, dpsi)
    n, c = z.shape
    dz = torch.empty_like(z)
    dg = torch.empty_like(g)
    if n:
        BWD.launch(z.device, z.data_ptr(), y.data_ptr(), g.data_ptr(),
                   dphi.data_ptr(), dpsi.data_ptr(), dz.data_ptr(),
                   dg.data_ptr(), n, c)
    return dz, dg


class DistillPhiPsi(torch.autograd.Function):
    """(phi, psi) per sample, differentiable in logits and targets (the
    labels are not)."""

    @staticmethod
    def forward(ctx, z, y, g):
        ctx.save_for_backward(z, y, g)
        return phi_psi_fwd(z, y, g)

    @staticmethod
    def backward(ctx, dphi, dpsi):
        z, y, g = ctx.saved_tensors
        dz, dg = phi_psi_bwd(z, y, g, dphi, dpsi)
        return dz.to(z.dtype), None, dg.to(g.dtype)


def distill_phi_psi(z, y, g):
    """Per-sample (phi, psi): z (N, C); y (N,) int64; g (N, C) KD target
    rows.  Forward and backward run as the CUDA kernels on the GPU."""
    return DistillPhiPsi.apply(z, y, g)


def distill_loss_plain(logits, labels, g_rows, beta):
    """Plain forward of the fused loss (the reference's
    ``distill_loss_ref``): (N,) float32."""
    z = logits.to(torch.float32)
    lse = torch.logsumexp(z, dim=-1)
    zy = z.gather(-1, labels.long()[:, None])[:, 0]
    gz = (g_rows.to(torch.float32) * z).sum(-1)
    return (lse - zy) + beta * (lse - gz)


def distill_loss(logits, labels, g_rows, beta: float):
    """Per-sample ``phi + beta * psi`` with psi = lse - g . z: logits
    (N, C) float32, labels (N,) int64, g_rows (N, C) float32, beta a
    float.  Forward only: raises if a gradient is asked for."""
    if torch.is_grad_enabled() and (logits.requires_grad
                                    or g_rows.requires_grad):
        raise RuntimeError(
            "distill_loss is forward only (the reference kernel has no "
            "gradient); differentiate through distill_phi_psi instead")
    if not on_cuda(logits, labels, g_rows):
        return distill_loss_plain(logits, labels, g_rows, beta)
    _check(logits, labels, g_rows)
    n, c = logits.shape
    out = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n:
        LOSS.launch(logits.device, logits.data_ptr(), labels.data_ptr(),
                    g_rows.data_ptr(), out.data_ptr(), n, c, float(beta))
    return out
