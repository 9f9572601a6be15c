"""Per-label average output vectors (eq. 2) — the FD uplink payload —
and the vocab-bucketed LM adaptation."""
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


def bucket_block(vocab: int, num_buckets: int) -> int:
    return -(-vocab // num_buckets)  # ceil


def bucketize_tokens(tokens, vocab: int, num_buckets: int):
    """Contiguous-block vocab bucketing for the LM adaptation."""
    return tokens // bucket_block(vocab, num_buckets)


def bucket_log_probs(logits, num_buckets: int):
    """log P(bucket) from token logits (..., V), in float32.

    Buckets are contiguous vocab blocks; log P(bucket) = logsumexp over
    the block minus logsumexp over the vocab.  A vocab that does not
    fill the last block is padded with -1e30."""
    V = logits.shape[-1]
    block = bucket_block(V, num_buckets)
    pad = num_buckets * block - V
    lf = logits.to(torch.float32)
    if pad:
        lf = F.pad(lf, (0, pad), value=-1e30)
    lb = lf.reshape(*lf.shape[:-1], num_buckets, block)
    blse = torch.logsumexp(lb, dim=-1)
    return blse - torch.logsumexp(blse, dim=-1, keepdim=True)
