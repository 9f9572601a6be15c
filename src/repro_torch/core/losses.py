"""Losses: cross-entropy phi (eq. 1) and the KD regularizer psi (eq. 3/5).

The paper writes psi = sum_m G_m log F_m; as a *loss* to descend this is
the cross-entropy between the global average output G and the local
prediction F (the conventional -sum G log F).
"""
from __future__ import annotations

import torch

from ..kernels.distill_loss import distill_phi_psi


def cross_entropy(logits, labels):
    """phi: mean CE. logits (..., C); labels int (...,) or one-hot/soft."""
    logp = torch.log_softmax(logits, dim=-1)
    if not labels.is_floating_point():
        return -logp.gather(-1, labels[..., None])[..., 0].mean()
    return -(labels * logp).sum(-1).mean()


def kd_regularizer(logits, target_probs):
    """psi: CE between teacher distribution and student prediction."""
    logp = torch.log_softmax(logits, dim=-1)
    return -(target_probs * logp).sum(-1).mean()


def fd_loss(logits, labels, gout, beta: float, *, use_kernel=None):
    """eq. (3)/(5): phi + beta * psi, with the KD target row selected by
    the ground-truth label.  gout: (C, C) — row n is the global average
    output for ground-truth label n.

    2-D logits with integer labels go through the ``distill_phi_psi``
    kernel pair (forward and backward); soft labels, or
    ``use_kernel=False``, take the plain path."""
    if use_kernel is None:
        use_kernel = (logits.dim() == 2 and labels.dim() == 1
                      and not labels.is_floating_point())
    if use_kernel:
        phi_s, psi_s = distill_phi_psi(logits, labels, gout[labels])
        phi, psi = phi_s.mean(), psi_s.mean()
        return phi + beta * psi, (phi, psi)
    phi = cross_entropy(logits, labels)
    psi = kd_regularizer(logits, gout[labels])
    return phi + beta * psi, (phi, psi)
