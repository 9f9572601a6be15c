"""IID / non-IID partitioning across federated devices (Sec. IV).

IID: every label has the same number of samples per device.
non-IID (the paper's recipe): two randomly selected labels get 2 samples
each, every other label gets 62 (|S_d| = 500, N_L = 10).
Dirichlet: per-device label proportions drawn from Dir(alpha).

Host numpy, as in the reference, so the index draws are identical.
:class:`PartitionSpec` names one recipe as a hashable value.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: Registered partitioning recipes.
PARTITION_SCHEMES = ("iid", "noniid", "dirichlet")


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


def _assemble(rng, x, y, counts):
    """Consume each class pool for the (D, C) per-device counts: devices
    get disjoint samples until a class runs out, then the shortfall is
    resampled with replacement; one stable sort puts each device's rows
    together, one batched shuffle mixes them."""
    num_devices, num_classes = counts.shape
    dev_of, samp = [], []
    for c in range(num_classes):
        need = counts[:, c]
        total = int(need.sum())
        pool = rng.permutation(np.flatnonzero(y == c))
        if total and pool.size < total:  # recycle if exhausted
            extra = rng.choice(np.flatnonzero(y == c), total - pool.size)
            pool = np.concatenate([pool, extra])
        dev_of.append(np.repeat(np.arange(num_devices), need))
        samp.append(pool[:total])
    dev_of = np.concatenate(dev_of)
    samp = np.concatenate(samp)
    order = np.argsort(dev_of, kind="stable")
    idx = samp[order].reshape(num_devices, -1)
    idx = rng.permuted(idx, axis=1)             # per-device shuffle, batched
    return x[idx], y[idx]


def partition_noniid(x, y, num_devices: int, num_classes: int = 10,
                     rare_labels: int = 2, rare_count: int = 2,
                     common_count: int = 62, seed: int = 0):
    """The paper's recipe: per device, ``rare_labels`` distinct classes
    (one batched per-row permutation) get ``rare_count`` samples, every
    other class ``common_count``."""
    rng = np.random.default_rng(seed)
    x, y = _numpy(x), _numpy(y)
    rare = rng.permuted(
        np.tile(np.arange(num_classes), (num_devices, 1)),
        axis=1)[:, :rare_labels]
    counts = np.full((num_devices, num_classes), common_count, np.int64)
    np.put_along_axis(counts, rare, rare_count, axis=1)
    return _assemble(rng, x, y, counts)


def partition_dirichlet(x, y, num_devices: int, per_device: int,
                        num_classes: int, alpha: float = 1.0, seed: int = 0):
    """Device d draws its per-class counts from Multinomial(per_device,
    q_d) with q_d ~ Dir(alpha * 1_C).  Small ``alpha`` concentrates each
    device on few labels; large ``alpha`` approaches IID."""
    if alpha <= 0:
        raise ValueError(f"dirichlet alpha must be > 0, got {alpha}")
    rng = np.random.default_rng(seed)
    x, y = _numpy(x), _numpy(y)
    props = rng.dirichlet(np.full(num_classes, float(alpha)),
                          size=num_devices)            # (D, C)
    counts = np.stack([rng.multinomial(per_device, p) for p in props])
    return _assemble(rng, x, y, counts)


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """One partitioning recipe: ``scheme``, the per-device sample count
    ``n_local`` (for ``noniid`` the common-label count is scaled so the
    row sums to it), the Dirichlet ``alpha`` and the partitioner's
    ``seed``."""
    scheme: str = "iid"
    n_local: int = 500
    alpha: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.scheme not in PARTITION_SCHEMES:
            raise ValueError(f"unknown partition scheme {self.scheme!r}; "
                             f"one of {PARTITION_SCHEMES}")
        if self.n_local < 1:
            raise ValueError(f"n_local must be >= 1, got {self.n_local}")
        if self.alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")

    def build(self, x, y, num_devices: int, num_classes: int):
        """(dev_x (D, n_local, ...), dev_y (D, n_local)) numpy arrays from
        a flat sample pool (numpy arrays or tensors)."""
        shape = _numpy(y).shape
        if len(shape) != 1:
            raise ValueError(
                "PartitionSpec.build partitions a flat sample pool "
                f"(y must be 1-D, got shape {shape}); "
                "partitioned grids take the raw pool, not (D, n) data")
        if self.scheme == "iid":
            return partition_iid(x, y, num_devices, self.n_local,
                                 num_classes, seed=self.seed)
        if self.scheme == "dirichlet":
            return partition_dirichlet(x, y, num_devices, self.n_local,
                                       num_classes, alpha=self.alpha,
                                       seed=self.seed)
        rare_labels, rare_count = 2, 2
        common = ((self.n_local - rare_labels * rare_count)
                  // (num_classes - rare_labels))
        if common < 1:
            raise ValueError(
                f"n_local={self.n_local} too small for the noniid recipe "
                f"with {num_classes} classes (needs >= "
                f"{rare_labels * rare_count + num_classes - rare_labels})")
        n_eff = rare_labels * rare_count + (num_classes - rare_labels) * \
            common
        if n_eff != self.n_local:
            raise ValueError(
                f"noniid n_local must satisfy n_local = {rare_labels}*"
                f"{rare_count} + {num_classes - rare_labels}*common; "
                f"nearest to {self.n_local} is {n_eff}")
        return partition_noniid(x, y, num_devices, num_classes,
                                rare_labels=rare_labels,
                                rare_count=rare_count,
                                common_count=common, seed=self.seed)


def protocol_dataset(num_devices: int = 10, per_device: int = 500,
                     iid: bool = True, n_test: int = 1000, seed: int = 0,
                     device=None):
    """The training CLI's paper dataset (the benchmark harness's
    ``protocol_dataset``): synthetic digits from ``PRNGKey(seed)`` on
    ``device`` (default: the GPU), the first ``num_devices *
    per_device`` split IID or by the paper's non-IID recipe (numpy
    arrays), the rest the test set (tensors)."""
    from .. import rng
    from .synthetic import synthetic_images

    ntr = num_devices * per_device
    x, y = synthetic_images(rng.PRNGKey(seed), ntr + n_test, device=device)
    if iid:
        dev_x, dev_y = partition_iid(x[:ntr], y[:ntr], num_devices,
                                     per_device, 10, seed=seed)
    else:
        dev_x, dev_y = partition_noniid(x[:ntr], y[:ntr], num_devices,
                                        seed=seed)
    return dev_x, dev_y, x[ntr:], y[ntr:]
