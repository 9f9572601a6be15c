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

:func:`distill_step` is B2 redesigned for one local SGD step of D
devices with B rows each: the forward, the backward for the cotangents
the step always passes (dphi = 1/B, dpsi = beta/B), the per-device loss
and the step's eq. (2) sums, in one launch of the fourth kernel of
``csrc/distill.cu`` on the GPU; :func:`distill_step_plain` on the CPU.
beta and the step index are device scalars, so a captured CUDA graph of
the step reads them at each replay.
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
STEP = CudaKernel("distill_step", "distill.cu", "distill_step_launch",
                  [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 4)
#: shared memory one distill_step CTA may take (B (C + 3) words)
STEP_SMEM_BYTES = 48 * 1024


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


def distill_step_plain(z, y, gout, beta, k, losses, out_sum, cnt):
    """Plain version of :func:`distill_step`, with the formulas of the
    eager step: the autograd function's forward and backward
    (:func:`phi_psi_plain`, :func:`phi_psi_bwd_plain`), ``one_hot``,
    ``softmax`` and a ``bmm`` for the eq. (2) sums."""
    D, B, C = z.shape
    dev = torch.arange(D, device=z.device)[:, None]
    zf, yf = z.reshape(D * B, C), y.reshape(D * B)
    gf = gout[dev, y].reshape(D * B, C)
    phi, psi = phi_psi_plain(zf, yf, gf)
    beta = beta.reshape(())
    loss = phi.view(D, B).mean(1) + beta * psi.view(D, B).mean(1)
    ones = torch.ones(D * B, dtype=z.dtype, device=z.device)
    dz, _ = phi_psi_bwd_plain(zf, yf, gf, ones / B, beta * ones / B)
    losses.index_copy_(1, k.reshape(1), loss[:, None])
    oh = torch.nn.functional.one_hot(y, C).to(torch.float32)
    out_sum += oh.transpose(1, 2) @ torch.softmax(z, -1)
    cnt += oh.sum(1)
    return dz.view(D, B, C)


def distill_step(z, y, gout, beta, k, losses, out_sum, cnt):
    """One local step's distill work for D devices of B rows: z (D, B, C)
    float32 logits, y (D, B) int64 labels in [0, C), gout (D, C, C) each
    device's G_out, beta a one-element float32 tensor, k a one-element
    int64 tensor (the step index).  Returns dz (D, B, C), the gradient of
    sum_d [mean_B phi + beta mean_B psi] in z; writes the per-device loss
    into ``losses[:, k]`` (losses (D, K)) and adds the step's
    ``onehot(y)^T softmax(z)`` to ``out_sum`` (D, C, C) and
    ``onehot(y)`` to ``cnt`` (D, C), in place."""
    args = (z, y, gout, beta, k, losses, out_sum, cnt)
    if not on_cuda(*args):
        return distill_step_plain(*args)
    require(z.dim() == 3, f"distill_step takes (D, B, C) logits, got "
            f"{tuple(z.shape)}")
    D, B, C = z.shape
    require(y.shape == (D, B) and y.dtype == torch.int64 and k.numel() == 1
            and k.dtype == torch.int64,
            "distill_step takes (D, B) int64 labels and an int64 step")
    require(gout.shape == (D, C, C) and out_sum.shape == (D, C, C)
            and cnt.shape == (D, C) and losses.dim() == 2
            and losses.shape[0] == D and beta.numel() == 1,
            "distill_step: gout and out_sum (D, C, C), cnt (D, C), losses "
            "(D, K), beta one element")
    require(all(t.dtype == torch.float32
                for t in (z, gout, beta, losses, out_sum, cnt)),
            "distill_step takes float32 logits, tables and sums")
    require(all(t.is_contiguous() for t in args),
            "distill_step operands must be contiguous")
    require(B * (C + 3) * 4 <= STEP_SMEM_BYTES,
            f"distill_step: B (C + 3) words must fit {STEP_SMEM_BYTES} "
            f"bytes of shared memory, got B={B}, C={C}")
    dz = torch.empty_like(z)
    if D and B:
        STEP.launch(z.device, z.data_ptr(), y.data_ptr(), gout.data_ptr(),
                    beta.data_ptr(), k.data_ptr(), dz.data_ptr(),
                    losses.data_ptr(), out_sum.data_ptr(), cnt.data_ptr(),
                    D, B, C, losses.shape[1])
    return dz
