"""Mixup (eq. 6) and inverse-Mixup (eq. 7-10, Proposition 1).

Mixup at a device:        s_hat = lam * s_i + (1 - lam) * s_j
Inverse-Mixup at server:  s_tilde_n = sum_d lam_hat[n, d] * s_hat_d
where lam_hat = inv(circulant(lams)) (Prop. 1).  For N = 2 and the target
hard label on the lam-class:  lam_hat = lam / (2*lam - 1)  (an
*extrapolation* — the ratios are negative for lam < 0.5, which is exactly
how unmixing works without ever reconstructing a raw sample).

The pairing and cycle search are host numpy, copied unchanged from the
reference so that they return the same pairs and cycles.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import rng
from ..kernels.mixup_kernel import mixup


# ---------------------------------------------------------------------------
# Proposition 1
# ---------------------------------------------------------------------------

def circulant(lams):
    """Rows are cyclic shifts of (lam_1 .. lam_N) per eq. (8)."""
    lams = torch.as_tensor(lams, dtype=torch.float32)
    n = lams.shape[0]
    idx = (torch.arange(n)[:, None] + torch.arange(n)[None, :]) % n
    return lams[idx]


def inverse_mixup_ratios(lams):
    """(N,) mixing ratios -> (N, N) inverse ratios; row n yields the sample
    whose hard label is the n-th constituent's label."""
    return torch.linalg.inv(circulant(lams))


# ---------------------------------------------------------------------------
# Device-side Mixup (eq. 6)
# ---------------------------------------------------------------------------

def mixup_pairs(key, labels, n_pairs: int, num_classes: int):
    """Sample ``n_pairs`` index pairs (i, j) with different labels, for a
    batch of devices: key (..., 2), labels (..., n) -> (..., n_pairs) each.

    Rejection-free: draw i uniformly, then draw j uniformly among samples
    of a uniformly-drawn *other* class (gumbel-max over the class mask).
    """
    n = labels.shape[-1]
    k = rng.split(key, 3)
    idx_i = rng.randint(k[..., 0, :], (n_pairs,), 0, n)
    li = torch.gather(labels, -1, idx_i)
    shift = rng.randint(k[..., 1, :], (n_pairs,), 1, num_classes)
    lj = (li + shift) % num_classes
    g = rng.gumbel(k[..., 2, :], (n_pairs, n))
    mask = labels[..., None, :] == lj[..., :, None]
    idx_j = torch.where(mask, g, -torch.inf).argmax(-1)
    return idx_i, idx_j


def _gather_rows(dev_x, idx):
    """dev_x (D, n, ...), idx (D, k) -> (D, k, ...)."""
    return dev_x[torch.arange(dev_x.shape[0],
                              device=dev_x.device)[:, None], idx]


def make_mixup_batch_kernel(dev_x, dev_y, idx_i, idx_j, lam: float,
                            num_classes: int):
    """Device-axis-batched eq. (6) through the mixup kernel (the
    counterpart of the reference's ``make_mixup_batch_pallas``).

    dev_x: (D, n_local, ...); dev_y: (D, n_local); idx_i/idx_j: (D, Ns).
    All D * Ns sample mixes run as one flattened (rows x features) kernel
    call; the label mixes stay plain.  Returns (mixed, soft, (minor,
    major)), each (D, Ns, ...)."""
    xi = _gather_rows(dev_x, idx_i)
    xj = _gather_rows(dev_x, idx_j)
    d, ns = idx_i.shape
    la = torch.full((d * ns,), lam, dtype=torch.float32, device=xi.device)
    mixed = mixup(xi.reshape(d * ns, -1), xj.reshape(d * ns, -1),
                  la, 1.0 - la).reshape(xi.shape)
    minor = torch.gather(dev_y, 1, idx_i)
    major = torch.gather(dev_y, 1, idx_j)
    soft = (lam * F.one_hot(minor, num_classes).to(torch.float32) +
            (1.0 - lam) * F.one_hot(major, num_classes).to(torch.float32))
    return mixed, soft, (minor, major)


# ---------------------------------------------------------------------------
# Server-side pairing + inverse-Mixup (eq. 7)
# ---------------------------------------------------------------------------

def pair_symmetric(minor, major, device_ids):
    """Vectorized pairing of mixed samples with *symmetric* labels from
    *different* devices: (a, b) pairs with (b, a), d != d'.

    Sort-based over the whole upload set (no per-sample Python loop):
    uploads are keyed by their unordered label pair, split by orientation
    (a < b vs a > b), and rank-aligned within each key group.  Sorting the
    forward side by device ascending and the reverse side descending
    minimises same-device alignments; the (typically few) leftovers —
    rank misalignments and same-device drops — are re-matched by a small
    greedy repair pass, and an augmenting swap pass absorbs same-device
    leftovers through already-matched pairs (leftovers of one key all
    share a device; a matched pair of that key whose members both avoid
    it can be rewired to take one leftover in), so the yield never falls
    below a plain greedy matcher's.  Returns an (M, 2) int array of
    index pairs.
    """
    minor = np.asarray(minor)
    major = np.asarray(major)
    device_ids = np.asarray(device_ids, np.int64)  # signed: `-dev` sort key
    n = minor.shape[0]
    empty = np.zeros((0, 2), np.int64)
    if n == 0:
        return empty
    valid = minor != major
    lo = np.minimum(minor, major)
    hi = np.maximum(minor, major)
    base = int(hi.max()) + 1 if n else 1
    key = lo.astype(np.int64) * base + hi
    idx = np.arange(n)
    f = idx[valid & (minor < major)]
    r = idx[valid & (minor > major)]
    if f.size == 0 or r.size == 0:
        return empty
    f = f[np.lexsort((device_ids[f], key[f]))]
    r = r[np.lexsort((-device_ids[r], key[r]))]

    def _ranks(order):  # position within each run of equal keys
        k = key[order]
        starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
        return np.arange(k.size) - np.repeat(
            starts, np.diff(np.r_[starts, k.size]))

    rmax = n + 1
    code_f = key[f] * rmax + _ranks(f)
    code_r = key[r] * rmax + _ranks(r)   # sorted by construction
    pos = np.searchsorted(code_r, code_f)
    pos_c = np.minimum(pos, code_r.size - 1)
    hit = (pos < code_r.size) & (code_r[pos_c] == code_f)
    i, j = f[hit], r[pos_c[hit]]
    keep = device_ids[i] != device_ids[j]
    i, j = i[keep], j[keep]

    # greedy repair over the leftovers (small: only misaligned ranks and
    # same-device drops survive the bulk pass)
    used = np.zeros(n, bool)
    used[i] = True
    used[j] = True
    by_key: dict[int, list[int]] = {}
    for b in r:
        if not used[b]:
            by_key.setdefault(int(key[b]), []).append(b)
    extra_i, extra_j = [], []
    for a in f:
        if used[a]:
            continue
        lst = by_key.get(int(key[a]))
        if not lst:
            continue
        for t, b in enumerate(lst):
            if device_ids[a] != device_ids[b]:
                extra_i.append(a)
                extra_j.append(b)
                lst.pop(t)
                break
    i = list(np.concatenate([i, np.asarray(extra_i, np.int64)]))
    j = list(np.concatenate([j, np.asarray(extra_j, np.int64)]))

    # augmenting swap pass: leftovers that survive the repair all share
    # one device per key (a cross-device leftover pair would have been
    # repaired), so a matched pair (i_t, j_t) of the same key with both
    # members off that device absorbs one leftover (a, b): rewire to
    # (a, j_t) and add (i_t, b).  Longer augmenting chains cannot help —
    # any pair already touching the leftover device blocks on it again.
    used[i] = True
    used[j] = True
    left_f: dict[int, list[int]] = {}
    left_r: dict[int, list[int]] = {}
    for a in f:
        if not used[a]:
            left_f.setdefault(int(key[a]), []).append(a)
    for b in r:
        if not used[b]:
            left_r.setdefault(int(key[b]), []).append(b)
    if left_f and left_r:
        pairs_of: dict[int, list[int]] = {}
        for t in range(len(i)):
            pairs_of.setdefault(int(key[i[t]]), []).append(t)
        for k_, fa in left_f.items():
            rb = left_r.get(k_)
            if not rb:
                continue
            ts = pairs_of.get(k_, [])
            for a, b in zip(fa, rb):
                if device_ids[a] != device_ids[b]:  # unreachable after
                    i.append(a)                     # repair; kept as a
                    j.append(b)                     # safety net
                    continue
                d = device_ids[a]
                for pos, t in enumerate(ts):
                    if device_ids[i[t]] != d and device_ids[j[t]] != d:
                        i.append(i[t])
                        j.append(b)
                        i[t] = a        # pair t becomes (a, j_t)
                        ts.pop(pos)     # its forward now sits on d
                        break
    return np.stack([np.asarray(i, np.int64),
                     np.asarray(j, np.int64)], axis=1)

def cycle_lams(n: int, lam: float):
    """Ratio vector (lam, 1-lam, 0, ..., 0) of length ``n``: the cyclic
    lam-order of a length-``n`` label cycle (a symmetric pair is n = 2).
    ``circulant(cycle_lams(n))`` is invertible whenever lam != 0.5."""
    v = torch.zeros(n, dtype=torch.float32)
    v[0] = lam
    v[1] = 1.0 - lam
    return v


def find_label_cycles_dfs(minor, major, device_ids, length: int,
                          max_steps: int = 200_000):
    """Reference (small-n) cycle search: disjoint label cycles of the
    given length among uploaded mixed samples — sequences (e_1 .. e_n)
    with major[e_k] == minor[e_{k+1}] (cyclically) and adjacent members
    from different devices.

    Host-side greedy DFS on the minor->major label multigraph, bounded by
    ``max_steps`` node expansions in total — a label graph whose chains
    never close (worst case for DFS) exhausts the budget and returns
    whatever was found instead of blowing up exponentially; callers
    degrade gracefully (fewer augmentation samples).  Kept as the parity
    oracle for :func:`find_label_cycles_segment`, which has no budget and
    is the production path.  Returns a (G, length) int array (rows are
    disjoint within one call; different lengths may reuse uploads — they
    produce distinct inverse samples).
    """
    minor = np.asarray(minor)
    major = np.asarray(major)
    device_ids = np.asarray(device_ids)
    n = minor.shape[0]
    succ: dict[int, list[int]] = {}
    for i in range(n):
        # degenerate uploads (minor == major) would yield single-class
        # "inverse" samples; keep them out of cycle membership entirely,
        # not just out of the start set
        if minor[i] == major[i]:
            continue
        succ.setdefault(int(minor[i]), []).append(i)
    used: set[int] = set()
    cycles: list[list[int]] = []
    budget = [max_steps]

    def _extend(path: list[int]) -> bool:
        if len(path) == length:
            return device_ids[path[-1]] != device_ids[path[0]]
        closing = len(path) == length - 1
        for cand in succ.get(int(major[path[-1]]), ()):
            if budget[0] <= 0:
                return False
            budget[0] -= 1
            if cand in used or cand in path:
                continue
            if device_ids[cand] == device_ids[path[-1]]:
                continue
            # the last member must close the label cycle back to the start
            if closing and int(major[cand]) != int(minor[path[0]]):
                continue
            path.append(cand)
            if _extend(path):
                return True
            path.pop()
        return False

    for start in range(n):
        if budget[0] <= 0:
            break
        if start in used or minor[start] == major[start]:
            continue
        path = [start]
        if _extend(path):
            used.update(path)
            cycles.append(path)
    if not cycles:
        return np.zeros((0, length), np.int64)
    return np.asarray(cycles, np.int64)


def _cycle_successors(minor, major, device_ids, alive, sweep: int,
                      stream: int):
    """One injective partial successor map over the ``alive`` edge subset
    of the minor->major label multigraph.

    Edges needing a successor are sorted by major label and candidate
    successors by minor label; within each label segment the two sides
    are rank-aligned.  The first sweep of stream 0 anti-aligns devices
    (pred side device-ascending, succ side device-descending — the
    ``pair_symmetric`` trick) to minimise same-device alignments; later
    sweeps shuffle within segments with a deterministic per-(stream,
    sweep) RNG so repeat passes explore different matchings.  Same-device
    alignments are dropped — the reshuffled sweeps recover them.  Returns
    succ: (n,) int64 with -1 for edges without a successor; distinct
    ranks within a segment make the map injective, so the successor
    graph is simple paths + simple cycles (no rho shapes).
    """
    if sweep == 0 and stream == 0:
        p = alive[np.lexsort((device_ids[alive], major[alive]))]
        s = alive[np.lexsort((-device_ids[alive], minor[alive]))]
    else:
        rng = np.random.default_rng((stream << 20) + sweep)
        p = alive[np.lexsort((rng.random(alive.size), major[alive]))]
        s = alive[np.lexsort((rng.random(alive.size), minor[alive]))]
    n_labels = int(max(minor[alive].max(), major[alive].max())) + 1
    cnt_p = np.bincount(major[p], minlength=n_labels)
    cnt_s = np.bincount(minor[s], minlength=n_labels)
    start_p = np.concatenate(([0], np.cumsum(cnt_p)[:-1]))
    start_s = np.concatenate(([0], np.cumsum(cnt_s)[:-1]))
    rank_p = np.arange(p.size) - start_p[major[p]]
    size_s = cnt_s[major[p]]
    has = rank_p < size_s          # demand beyond the supply gets nothing
    src = p[has]
    cand = s[start_s[major[src]] + rank_p[has]]
    ok = device_ids[src] != device_ids[cand]
    succ = np.full(minor.shape[0], -1, np.int64)
    succ[src[ok]] = cand[ok]
    return succ


def _extract_cycle_windows(succ, minor, major, device_ids, length: int):
    """Disjoint length-``length`` label cycles from one successor map.

    Walks ``length - 1`` pointer steps from every edge (the successor
    graph is injective, so trails never merge); a window
    [i, succ(i), ..., succ^{L-1}(i)] is a valid cycle iff it is revisit-
    free and closes label- and device-wise (major of the last == minor of
    the first, different devices).  Overlapping windows are resolved by
    claim rounds: every surviving start scatter-claims its members with
    min-index priority and keeps the window only if it won all of them —
    the globally minimal start always wins, so each round makes progress.
    Returns (W, length) rows.
    """
    n = succ.shape[0]
    succ_ext = np.concatenate((succ, [-1]))        # index -1 stays -1
    trail = np.empty((length, n), np.int64)
    trail[0] = np.arange(n)
    for k in range(1, length):
        trail[k] = succ_ext[trail[k - 1]]
    last = trail[length - 1]
    ok = last >= 0
    # injective map => a revisit implies a sub-cycle through the start,
    # so "no member equals the start" is exactly pairwise distinctness
    ok &= np.all(trail[1:] != trail[0], axis=0)
    safe = np.maximum(last, 0)
    ok &= major[safe] == minor[trail[0]]
    ok &= device_ids[safe] != device_ids[trail[0]]
    starts = np.flatnonzero(ok)

    rows = []
    used = np.zeros(n, bool)
    while starts.size:
        members = trail[:, starts]                 # (L, S)
        claim = np.full(n, n, np.int64)
        np.minimum.at(claim, members.ravel(),
                      np.broadcast_to(starts, members.shape).ravel())
        win = np.all(claim[members] == starts[None, :], axis=0)
        won = trail[:, starts[win]]
        rows.append(won.T)
        used[won.ravel()] = True
        starts = starts[~win]
        starts = starts[~np.any(used[trail[:, starts]], axis=0)]
    if not rows:
        return np.zeros((0, length), np.int64)
    return np.concatenate(rows, axis=0)


def _segment_stream(minor, major, device_ids, length: int, stream: int,
                    miss_budget: int, polish_cap: int):
    """One best-effort cycle packing: matching sweeps until ``miss_budget``
    consecutive empty sweeps, then a DFS polish over the (small, capped)
    leftover edge set that re-matching no longer reaches."""
    alive_mask = minor != major    # degenerate edges never join cycles
    rows_all = []
    sweep = misses = 0
    while True:
        alive = np.flatnonzero(alive_mask)
        if alive.size < length:
            break
        succ = _cycle_successors(minor, major, device_ids, alive, sweep,
                                 stream)
        rows = _extract_cycle_windows(succ, minor, major, device_ids,
                                      length)
        sweep += 1
        if rows.size == 0:
            misses += 1
            if misses >= miss_budget:
                break
            continue
        misses = 0
        rows_all.append(rows)
        alive_mask[rows.ravel()] = False
    left = np.flatnonzero(alive_mask)
    if length <= left.size <= polish_cap:
        sub = find_label_cycles_dfs(minor[left], major[left],
                                    device_ids[left], length)
        if len(sub):
            rows_all.append(left[sub])
    if not rows_all:
        return np.zeros((0, length), np.int64)
    return np.concatenate(rows_all, axis=0)


def find_label_cycles_segment(minor, major, device_ids, length: int,
                              miss_budget: int = 12,
                              polish_cap: int = 4096,
                              restarts: int = 6, small_n: int = 2048):
    """Vectorized segment/sort cycle search — the production replacement
    for :func:`find_label_cycles_dfs`, O(n log n) per sweep with no step
    budget, so augmentation no longer degrades beyond ~10^4 uploads.

    Each sweep builds one injective successor matching over the remaining
    edges (:func:`_cycle_successors`), extracts disjoint cycles from its
    pointer trails (:func:`_extract_cycle_windows`), and removes them;
    each sweep reshuffles the segment alignment so near-miss matchings
    (same-device drops, unlucky pairings) get rewired.  A stream stops
    after ``miss_budget`` consecutive empty sweeps and DFS-polishes its
    leftover (at most ``polish_cap`` edges, so the polish cost is
    bounded).  At small n (<= ``small_n``) up to ``restarts``
    deterministic shuffle streams run and the highest-yield packing wins
    — restarts close most of the packing gap to the greedy DFS while
    staying irrelevant (and skipped) at scale.  Degenerate edges with
    minor == major are excluded from membership up front.  Same contract
    as the DFS: (G, length) rows, disjoint within one call.
    """
    minor = np.asarray(minor)
    major = np.asarray(major)
    device_ids = np.asarray(device_ids, np.int64)  # signed: `-dev` sort key
    if minor.shape[0] == 0 or length < 2:
        return np.zeros((0, length), np.int64)
    streams = max(1, restarts) if minor.shape[0] <= small_n else 1
    # count upper bound of any packing: a stream that reaches it cannot
    # be beaten, so further restarts are redundant (a later stream only
    # replaces `best` on strictly greater yield — skipping ties is
    # behaviour-identical)
    max_cycles = int(np.count_nonzero(minor != major)) // length
    best = np.zeros((0, length), np.int64)
    for stream in range(streams):
        rows = _segment_stream(minor, major, device_ids, length, stream,
                               miss_budget, polish_cap)
        if len(rows) > len(best):
            best = rows
        if len(best) >= max_cycles:
            break
    return best


def find_label_cycles(minor, major, device_ids, length: int,
                      max_steps: int = 200_000, method: str = "auto",
                      small_n: int = 2048):
    """Disjoint label cycles of the given length among uploaded mixed
    samples (see :func:`find_label_cycles_segment` for the cycle
    contract and :func:`find_label_cycles_dfs` for the reference).

    ``method="auto"`` (default) runs the vectorized segment/sort search,
    and at small n (<= ``small_n``, where the DFS budget cannot bind)
    also runs the DFS oracle and keeps whichever packing yields more
    cycles — ties prefer the DFS for continuity with the pre-vectorized
    behaviour.  ``method="segment"`` is the pure vectorized path;
    ``method="dfs"`` the budgeted greedy reference (``max_steps`` only
    applies to DFS calls)."""
    if method == "dfs":
        return find_label_cycles_dfs(minor, major, device_ids, length,
                                     max_steps)
    if method not in ("segment", "auto"):
        raise ValueError(f"unknown cycle-search method {method!r}; "
                         "use 'auto', 'segment' or 'dfs'")
    minor = np.asarray(minor)
    rows = find_label_cycles_segment(minor, major, device_ids, length,
                                     small_n=small_n)
    if method == "auto" and 0 < minor.shape[0] <= small_n:
        # the DFS cannot beat a packing at the count upper bound — only
        # tie it — so skip the second search there
        max_cycles = int(np.count_nonzero(minor != np.asarray(major))
                         ) // length
        if len(rows) < max_cycles:
            ref = find_label_cycles_dfs(minor, major, device_ids, length,
                                        max_steps)
            if len(ref) >= len(rows):
                return ref
    return rows


def inverse_mixup_cycles(mixed, cycles, lam: float):
    """Batched general-N inverse-Mixup (Prop. 1) over label cycles.

    mixed: (M, F) uploaded mixed samples; cycles: (G, N) index rows from
    :func:`find_label_cycles`.  Member k of a cycle is lam * x_k +
    (1-lam) * x_{k+1 (mod N)} in class space, so the stack reordered by
    (N-k) mod N equals circulant(cycle_lams(N, lam)) @ x and one
    (N, N) @ (G, N, F) contraction recovers all G*N hard-label samples.
    Returns (G*N, F); labels are minor[cycles].ravel()."""
    cycles = np.asarray(cycles)
    g, n = cycles.shape
    ratios = inverse_mixup_ratios(cycle_lams(n, lam)).to(mixed.device)
    perm = (n - np.arange(n)) % n
    stack = mixed[torch.as_tensor(cycles[:, perm], device=mixed.device)]
    out = torch.einsum("nk,gkf->gnf", ratios, stack)
    return out.reshape(g * n, -1)
