"""IID partitioning across federated devices (Sec. IV): every label has
the same number of samples per device.  Host numpy, as in the reference,
so the index draw is identical; non-IID and Dirichlet partitions wait
for a later slice."""
from __future__ import annotations

import numpy as np
import torch


def _numpy(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def partition_iid(x, y, num_devices: int, per_device: int, num_classes: int,
                  seed: int = 0):
    """Device-axis vectorized: the full (D, per_device) index matrix is
    built with one per-class slice + one batched in-row shuffle (classes
    short on samples are resampled with replacement).  Takes numpy arrays
    or tensors, returns numpy arrays."""
    rng = np.random.default_rng(seed)
    x, y = _numpy(x), _numpy(y)
    per_class = per_device // num_classes
    need = num_devices * per_class
    cols = []
    for c in range(num_classes):
        pool = rng.permutation(np.flatnonzero(y == c))
        if pool.size < need:  # class exhausted: resample
            extra = rng.choice(np.flatnonzero(y == c), need - pool.size)
            pool = np.concatenate([pool, extra])
        cols.append(pool[:need].reshape(num_devices, per_class))
    idx = np.concatenate(cols, axis=1)      # (D, per_class * num_classes)
    idx = rng.permuted(idx, axis=1)         # per-device shuffle, batched
    return x[idx], y[idx]
