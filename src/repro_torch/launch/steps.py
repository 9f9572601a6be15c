"""Step builders: the train step (eq. 3 at LM scale: next-token CE plus
the Mix2FLD KD term, chunked over the sequence), cache-building prefill
and greedy decode, and the multi-pod federated sync steps (FL baseline vs
the paper's FLD).

Parameters are nested dicts of tensors; pod-stacked trees carry a
leading pod axis on every leaf.  Every update is out of place: a step
returns new tensors and never writes the ones it was given, so two
names may share a stack (``launch/train.py``'s server stack and pod
stack) without one's update reaching the other.  Where the reference
vmaps over pods, the port loops over them; no step reduces across pods
except the FD sync's (NB, NB) uplink mean and the FL sync's parameter
mean; across ranks, :func:`make_fd_sync_step_shardmap` holds one pod a
rank and all-reduces only that mean.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .. import optim
from ..core.outputs import bucket_log_probs, bucketize_tokens
from ..models import kvcache
from ..models.layers import checkpointed
from ..models.transformer import (forward, tree_leaves, tree_map,
                                  unembed_matrix)
from .mesh import all_reduce_sum


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def _rebuild(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def pod(tree, i: int):
    """Pod ``i``'s slice of a pod-stacked tree (views)."""
    return tree_map(lambda t: t[i], tree)


def stack_pods(trees):
    """One pod-stacked tree from a list of per-pod trees."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)


# ---------------------------------------------------------------------------
# Loss: next-token CE + Mix2FLD device-side KD regularizer (eq. 3 adapted)
# ---------------------------------------------------------------------------

LOSS_CHUNK = 512  # query positions per loss chunk
# gradient-accumulation dtype: f32 is the safe default (the reference's
# _ACCUM_DTYPE; bf16 halves the accumulators)
_ACCUM_DTYPE = [torch.float32]


def set_accum_dtype(dt):
    _ACCUM_DTYPE[0] = dt


def _chunk_losses(cfg, W, gout, h, tgt, msk):
    """CE + KD partial sums for one chunk. h: (B,C,D); tgt/msk: (B,C).
    The logits are the product in the parameters' dtype, then float32,
    as the reference's ``(h @ W).astype(f32)``."""
    lg = (h @ W).float()                                 # (B,C,V)
    logz = torch.logsumexp(lg, dim=-1)
    tl = lg.gather(-1, tgt[..., None])[..., 0]
    ce = ((logz - tl) * msk).sum()
    kd = torch.zeros((), dtype=torch.float32, device=h.device)
    if gout is not None:
        nb = cfg.fd_buckets
        blp = bucket_log_probs(lg, nb)
        tb = bucketize_tokens(tgt, cfg.vocab_size, nb)
        kd = -((gout[tb] * blp).sum(-1) * msk).sum()
    return ce, kd


def _lm_loss(cfg, params, batch):
    """Next-token CE + Mix2FLD KD, chunked over the sequence: each chunk
    of LOSS_CHUNK positions is recomputed in the backward, so the full
    (B, S, V) logits never exist for it."""
    hidden, aux, _ = forward(cfg, params, batch, return_hidden=True)
    B, S, D = hidden.shape
    W = unembed_matrix(cfg, params)
    labels = batch["labels"] if "labels" in batch else batch["tokens"]
    # shift: position t predicts labels[t+1]; last position is masked
    targets = torch.cat([labels[:, 1:], labels.new_zeros((B, 1))], dim=1)
    mask = (torch.arange(S, device=hidden.device) < S - 1).float() \
        .expand(B, S)
    gout = batch.get("gout")

    C = min(LOSS_CHUNK, S)
    if S % C == 0 and S > C:
        recompute = torch.is_grad_enabled()
        ce_sum = kd_sum = torch.zeros((), dtype=torch.float32,
                                      device=hidden.device)
        for c0 in range(0, S, C):
            args = (cfg, W, gout, hidden[:, c0:c0 + C],
                    targets[:, c0:c0 + C], mask[:, c0:c0 + C])
            ce, kd = checkpointed(recompute, _chunk_losses, *args)
            ce_sum = ce_sum + ce
            kd_sum = kd_sum + kd
    else:
        ce_sum, kd_sum = _chunk_losses(cfg, W, gout, hidden, targets, mask)

    denom = mask.sum().clamp_min(1.0)
    ce = ce_sum / denom
    kd = kd_sum / denom
    loss = ce + cfg.kd_beta * kd + aux
    return loss, {"ce": ce, "kd": kd, "aux": aux}


def value_and_grad(loss_fn, params, batch):
    """``((loss, parts), grads)`` of ``loss_fn(params, batch) -> (loss,
    parts)``, grads in the parameters' tree and dtypes."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, parts = loss_fn(_rebuild(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return ((loss.detach(), {k: v.detach() for k, v in parts.items()}),
            _rebuild(params, grads))


def make_train_step(cfg, grad_accum: int | None = None):
    """Paper-faithful device-side update: plain SGD on eq. (3).

    ``grad_accum`` > 1 splits the batch dim into microbatches and
    accumulates their gradients in ``promote(p.dtype, accum dtype)``:
    identical SGD math, activation memory divided by the accumulation
    factor (cfg.grad_accum by default).  Returns ``train_step(params,
    batch) -> (new params, metrics)``; ``params`` is not changed."""
    accum = grad_accum if grad_accum is not None else cfg.grad_accum
    loss_fn = functools.partial(_lm_loss, cfg)
    sgd = optim.sgd(cfg.learning_rate)   # p - lr * g.astype(p.dtype)

    def train_step(params, batch):
        per_seq = {k for k, v in batch.items()
                   if torch.is_tensor(v) and v.dim() >= 2 and k != "gout"}
        bsz = next(v.shape[0] for k, v in batch.items() if k in per_seq)
        accum_eff = accum if (accum <= bsz and bsz % accum == 0) else 1
        if accum_eff > 1:
            m = bsz // accum_eff
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.promote_types(p.dtype, _ACCUM_DTYPE[0]),
                device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=tree_leaves(params)[0].device)
            parts = []
            for i in range(accum_eff):
                mb = {k: (v[i * m:(i + 1) * m] if k in per_seq else v)
                      for k, v in batch.items()}
                (loss, p_i), g = value_and_grad(loss_fn, params, mb)
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi)
                loss_sum = loss_sum + loss
                parts.append(p_i)
            grads = tree_map(lambda g: g / accum_eff, grads)
            loss = loss_sum / accum_eff
            parts = {k: torch.stack([p[k] for p in parts]).mean()
                     for k in parts[0]}
        else:
            (loss, parts), grads = value_and_grad(loss_fn, params, batch)
        new, _ = sgd.update(grads, sgd.init(params), params)
        return new, dict(parts, loss=loss)

    return train_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg, seq_len: int):
    """tokens (B, S) or embeds (B, S, D), and enc_out for a
    cross-attention config -> (last-token logits, filled cache of
    ``seq_len``; the SSM cache, and the hybrid's mamba part, do not
    depend on ``seq_len``)."""

    def prefill_step(params, batch):
        inp = batch["tokens"] if "tokens" in batch else batch["embeds"]
        cache = kvcache.init_cache(cfg, inp.shape[0], seq_len,
                                   device=inp.device)
        logits, _, new_cache = forward(cfg, params, batch, cache=cache)
        return logits[:, -1], new_cache

    return prefill_step


def make_decode_step(cfg):
    """One token with a cache: greedy-sample and append.  The cache's
    tensors are updated in place."""

    def decode_step(params, batch):
        inp = {k: v for k, v in batch.items() if k != "cache"}
        logits, _, new_cache = forward(cfg, params, inp, cache=batch["cache"])
        nxt = torch.argmax(logits[:, -1], dim=-1)
        return nxt, new_cache

    return decode_step


# ---------------------------------------------------------------------------
# Multi-pod federated sync steps (the paper's protocol at pod granularity)
# ---------------------------------------------------------------------------

def make_local_train_step(cfg, n_pods: int):
    """Pod-local Mix2FLD device update: params carry a leading pod axis
    and each pod takes its own train step on its own batch, with no
    cross-pod reduction.  ``pod_batch`` leaves: (n_pods, ...).  Returns
    (new pod params, metrics with one value a pod)."""
    step = make_train_step(cfg)

    def local_step(pod_params, pod_batch):
        outs = [step(pod(pod_params, i), pod(pod_batch, i))
                for i in range(n_pods)]
        metrics = {k: torch.stack([m[k] for _, m in outs])
                   for k in outs[0][1]}
        return stack_pods([p for p, _ in outs]), metrics

    return local_step


def make_fl_sync_step(cfg, n_pods: int):
    """FL baseline sync: full-parameter cross-pod average (the fat uplink
    the paper avoids), in float32, broadcast back to every pod."""

    def fl_sync(pod_params):
        return tree_map(
            lambda p: p.float().mean(0).to(p.dtype)[None].expand(p.shape)
            .contiguous(), pod_params)

    return fl_sync


def make_fd_sync_step(cfg, n_pods: int, ks_iters: int = 4):
    """Mix2FLD sync (uplink FD + downlink FL):

    1. uplink: the per-pod label-averaged output tables (n_pods, NB, NB),
       averaged over pods — the only cross-pod reduction;
    2. server output-to-model conversion: ``ks_iters`` SGD+KD steps
       (eq. 5) on the seed sequences, for each pod's replica (every pod
       runs the identical server step on its own consistent replica).
    Returns (new_pod_params, gout)."""

    sgd = optim.sgd(cfg.learning_rate)

    def convert(params, gout, seed_batch):
        b = dict(seed_batch, gout=gout)
        state = sgd.init(params)
        for _ in range(ks_iters):
            _, g = value_and_grad(functools.partial(_lm_loss, cfg), params, b)
            params, state = sgd.update(g, state, params)
        return params

    def fd_sync(pod_params, pod_favg, seed_batch):
        gout = pod_favg.mean(0)  # (NB, NB)
        return stack_pods([convert(pod(pod_params, i), gout, seed_batch)
                           for i in range(n_pods)]), gout

    return fd_sync


def make_fd_sync_step_shardmap(cfg, mesh, ks_iters: int = 4):
    """:func:`make_fd_sync_step` with one pod a rank of ``mesh`` (a
    DeviceMesh whose ranks are the pods, ``launch/mesh.py``): each rank
    passes its own pod's slice, leaves with a leading axis of 1.  The
    one cross-pod collective is the mean of the (NB, NB) uplink tables,
    an all-reduce divided by the pod count; each rank then converts its
    own replica with ``make_fd_sync_step(cfg, n_pods=1)``.  Returns
    (this pod's new params, leading axis 1; gout (1, NB, NB))."""
    inner = make_fd_sync_step(cfg, n_pods=1, ks_iters=ks_iters)
    n_pods = mesh.size()

    def fd_sync(pod_params, pod_favg, seed_batch):
        if pod_favg.shape[0] != 1:
            raise ValueError(f"each rank holds one pod: favg has "
                             f"{pod_favg.shape[0]}")
        gout = all_reduce_sum(pod_favg[0].clone()) / n_pods  # the uplink
        new_pp, _ = inner(pod_params, gout[None], seed_batch)
        return new_pp, gout[None]

    return fd_sync


# ---------------------------------------------------------------------------
# Device-side FD statistics (eq. 2 at LM scale): per-bucket average output
# ---------------------------------------------------------------------------

def make_favg_step(cfg):
    """The per-ground-truth-bucket average bucket-distribution table
    (NB, NB) from one batch — the Mix2FLD uplink payload.  It records no
    gradient, so its forward runs through the attention and SSD kernels
    on the GPU."""

    @torch.no_grad()
    def favg(params, batch):
        logits, _, _ = forward(cfg, params, batch)
        lg = logits[:, :-1].float()
        targets = (batch["labels"] if "labels" in batch
                   else batch["tokens"])[:, 1:]
        nb = cfg.fd_buckets
        bp = torch.exp(bucket_log_probs(lg, nb))       # (B,S-1,NB)
        tb = bucketize_tokens(targets, cfg.vocab_size, nb)
        oh = F.one_hot(tb, nb).float()
        sums = torch.einsum("bsn,bsm->nm", oh, bp)
        cnt = oh.sum((0, 1))
        return sums / cnt[:, None].clamp_min(1.0)

    return favg
