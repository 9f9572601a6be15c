"""Per-label average output vectors (eq. 2) — the FD uplink payload."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def label_averaged_outputs(probs, labels, num_classes: int):
    """eq. (2): F_bar[n] = mean of prob vectors over samples with label n.

    probs: (..., C) softmax outputs; labels: (...,) int.
    Returns (F_bar (num_classes, C), counts (num_classes,)); rows with
    zero count are zeros."""
    flat_p = probs.reshape(-1, probs.shape[-1]).to(torch.float32)
    onehot = F.one_hot(labels.reshape(-1), num_classes).to(torch.float32)
    sums = onehot.T @ flat_p
    counts = onehot.sum(0)
    return sums / counts[:, None].clamp_min(1.0), counts
