"""Round-1 seed collection (Algorithm 1's seed exchange) and its summary.

``collect_seeds`` draws the device-side Mixup pairs, mixes them through
the mixup kernel, pairs symmetric uploads server-side
(``pair_symmetric``), inverts the pairs through the mixup kernel, and
augments with inverse-Mixup over longer label cycles.  The reference's
content-keyed memo (``SeedPrepMemo`` / ``prepare_seeds``) waits for the
sweep engine.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import rng
from ..kernels.mixup_kernel import mixup
from .mixup import (_gather_rows, find_label_cycles, inverse_mixup_cycles,
                    make_mixup_batch_kernel, mixup_pairs, pair_symmetric)


def summarize_seeds(seeds) -> Optional[dict]:
    """Lightweight, JSON-ready metadata of one seed set: set sizes, pair
    count and the cycle-length histogram.  ``n_pairs``/``cycle_hist``
    describe the extraction before it is truncated (or tiled) to the
    ``n_inverse * D`` target; their sample total is ``n_extracted``."""
    if seeds is None:
        return None
    hist = {str(k): int(v) for k, v in seeds.get("cycle_hist", {}).items()}
    return {
        "n_train": int(seeds["train_x"].shape[0]),
        "n_uploaded": int(seeds["uploaded"].shape[0]),
        "n_pairs": int(seeds.get("n_pairs", 0)),
        "cycle_hist": hist,
        "n_extracted": sum(int(k) * v for k, v in hist.items()),
        "hard_labels": seeds["train_y"].dim() == 1,
    }


def collect_seeds(fc, dev_x, dev_y, key):
    """Round-1 seed collection, batched over the device axis.

    dev_x (D, n_local, ...), dev_y (D, n_local) int64 on one device; key
    (2,) on the same device.  Returns None for FL/FD, else a dict with
    the uploaded samples, the server's training set (``train_x``,
    ``train_y`` hard or soft) and the pairing metadata."""
    D = dev_x.shape[0]
    C = fc.num_classes
    proto = fc.protocol
    if proto in ("fl", "fd"):
        return None
    n_local = dev_x.shape[1]
    feat = tuple(dev_x.shape[2:])
    if proto == "fld" and fc.n_seed > n_local:
        raise ValueError(
            f"n_seed={fc.n_seed} seed samples per device cannot be drawn "
            f"without replacement from n_local={n_local} local samples; "
            "reduce FederatedConfig.n_seed or give each device more data")
    if proto in ("mixfld", "mix2fld") and n_local < 2:
        raise ValueError(
            f"Mixup seed collection needs at least 2 local samples per "
            f"device to draw cross-class pairs, got n_local={n_local}")
    keys = rng.split(key, D)

    if proto == "fld":  # raw samples (privacy leak, the baseline)
        idx = rng.choice(keys, n_local, (fc.n_seed,), replace=False)
        seeds_x = _gather_rows(dev_x, idx).reshape((D * fc.n_seed,) + feat)
        seeds_y = torch.gather(dev_y, 1, idx).reshape(-1)
        return {"train_x": seeds_x, "train_y": seeds_y,
                "uploaded": seeds_x, "raw_pairs": None}

    # ---- Mixup at devices (eq. 6), one kernel call over all D * Ns ----
    idx_i, idx_j = mixup_pairs(keys, dev_y, fc.n_seed, C)   # (D, Ns) each
    mixed, softs, (minors, majors) = make_mixup_batch_kernel(
        dev_x, dev_y, idx_i, idx_j, fc.lam, C)
    raws = torch.stack([_gather_rows(dev_x, idx_i),
                        _gather_rows(dev_x, idx_j)], dim=2)
    mixed = mixed.reshape((D * fc.n_seed,) + feat)
    softs = softs.reshape(D * fc.n_seed, C)
    minors = minors.reshape(-1).cpu().numpy()
    majors = majors.reshape(-1).cpu().numpy()
    raws = raws.reshape((D * fc.n_seed, 2) + feat)
    dev_ids = np.repeat(np.arange(D), fc.n_seed)
    soft_set = {"train_x": mixed, "train_y": softs,
                "uploaded": mixed, "raw_pairs": raws}

    if proto == "mixfld":
        return soft_set

    # ---- Mix2FLD: inverse-Mixup across devices (eq. 7, Prop. 1) ----
    if abs(2.0 * fc.lam - 1.0) < 1e-6:
        # lam = 0.5 makes the inverse ratios singular (Prop. 1);
        # degrade to soft-label training instead of dividing by zero
        return soft_set
    pairs = pair_symmetric(minors, majors, dev_ids)    # (P, 2)
    want_total = fc.n_inverse * D
    mixed_flat = mixed.reshape(mixed.shape[0], -1)
    inv_chunks, lab_chunks = [], []
    cycle_hist: dict[int, int] = {}
    if len(pairs):
        # one kernel call per side: s1 = lam_hat*m_i + (1-lam_hat)*m_j
        # and its mirror, for every pair at once
        lam_hat = fc.lam / (2.0 * fc.lam - 1.0)
        pt = torch.as_tensor(pairs, device=mixed.device)
        a = mixed_flat[pt[:, 0]]
        b = mixed_flat[pt[:, 1]]
        la = torch.full((len(pairs),), lam_hat, dtype=torch.float32,
                        device=mixed.device)
        s1 = mixup(a, b, la, 1.0 - la)
        s2 = mixup(b, a, la, 1.0 - la)
        inv_chunks.append(torch.stack([s1, s2], dim=1).reshape(
            2 * len(pairs), -1))
        lab_chunks.append(np.stack([minors[pairs[:, 0]],
                                    minors[pairs[:, 1]]], 1).reshape(-1))
        cycle_hist[2] = len(pairs)
    # augmentation beyond 2*P: longer label cycles draw distinct cyclic
    # lam-orders, so extra draws are new samples, not duplicates
    total = 2 * len(pairs)
    length = 3
    while total < want_total and length <= max(3, min(C, 6)):
        cycles = find_label_cycles(minors, majors, dev_ids, length)
        if len(cycles):
            inv_chunks.append(inverse_mixup_cycles(
                mixed_flat, cycles, fc.lam))
            lab_chunks.append(minors[cycles].reshape(-1))
            total += cycles.size
            cycle_hist[length] = len(cycles)
        length += 1
    if not inv_chunks:  # degenerate pairing: fall back to soft labels
        return soft_set
    inv_x = torch.cat(inv_chunks)
    inv_y = np.concatenate(lab_chunks)
    if inv_x.shape[0] < want_total:  # last resort: tile
        reps = -(-want_total // inv_x.shape[0])
        inv_x = inv_x.repeat(reps, 1)
        inv_y = np.tile(inv_y, reps)
    inv_x = inv_x[:want_total].reshape((-1,) + feat)
    inv_y = torch.as_tensor(inv_y[:want_total], dtype=torch.int64,
                            device=mixed.device)
    return {"train_x": inv_x, "train_y": inv_y,
            "uploaded": mixed, "raw_pairs": raws,
            "n_pairs": len(pairs), "cycle_hist": cycle_hist}
