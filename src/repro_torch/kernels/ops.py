"""Public wrappers over the kernels, with the reference's signatures
(``repro.kernels.ops``).  Each runs its CUDA kernel for CUDA tensors and
the plain PyTorch version for CPU tensors (``runtime.on_cuda``)."""
from __future__ import annotations

import torch

from .distill_loss import distill_loss as _distill_loss
from .flash_attention import flash_attention as _flash_attention
from .mixup_kernel import mixup as _mixup
from .ssd_scan import ssd_scan as _ssd_scan


def _full(n, value, like):
    return torch.full((n,), value, dtype=torch.float32, device=like.device)


def mixup(a, b, lam: float):
    """eq. (6): lam * a + (1 - lam) * b over a batch of flattened samples."""
    n = a.shape[0]
    out = _mixup(a.reshape(n, -1), b.reshape(n, -1), _full(n, lam, a),
                 _full(n, 1.0 - lam, a))
    return out.reshape(a.shape)


def inverse_mixup_pair(mixed_a, mixed_b, lam: float):
    """eq. (7), N=2: returns the two hard-labelled unmixed samples."""
    lam_hat = lam / (2.0 * lam - 1.0)
    n = mixed_a.shape[0]
    fa = mixed_a.reshape(n, -1)
    fb = mixed_b.reshape(n, -1)
    l1 = _full(n, lam_hat, fa)
    l2 = 1.0 - l1
    s1 = _mixup(fa, fb, l1, l2)
    s2 = _mixup(fa, fb, l2, l1)
    return s1.reshape(mixed_a.shape), s2.reshape(mixed_a.shape)


def distill_loss(logits, labels, gout, beta: float):
    """Mean of eq. (3) over a batch; gout: (C, C) KD table."""
    labels = labels.long()
    per = _distill_loss(logits, labels, gout[labels].contiguous(), beta)
    return per.mean()


def flash_attention(q, k, v, *, window=None):
    """Causal attention, (BH, S, d) layout (see kernels/flash_attention)."""
    return _flash_attention(q, k, v, window=window)


def ssd_scan(xdt, Bh, Ch, dA, *, chunk: int = 64):
    """Mamba2 SSD over (BH, S, .) tensors (see kernels/ssd_scan):
    per-head B and C, S a multiple of min(chunk, S); returns y."""
    return _ssd_scan(xdt, Bh, Ch, dA, min(chunk, xdt.shape[1]))
