"""Server-side output-to-model conversion (eq. 5, Algorithm 1 line 10).

The server transfers the knowledge in the global average output vectors
G_out into the global model by running K_s SGD-with-KD iterations over
the collected (for Mix2FLD, inversely mixed-up) seed samples;
:func:`output_to_model` runs them for one server model.  Plain
PyTorch losses, as the reference computes eq. 5 in plain jnp.  On the
GPU the steps are replays of a captured CUDA graph of one step
(``core/graphs.py``); on the CPU the same step runs eagerly.

:func:`output_to_model_steps` runs G stacked server models, each with
its own eta, beta, seed set (padded to the largest, ``n_train`` its live
prefix) and step count (``iters``, padded to the largest, ``K_max``), as
one captured step over the G models; a step past a model's ``iters``
leaves it unchanged.  A sweep group converts its G points so; the loop
(``FederatedTrainer``) converts its one server model as G = 1.  The step
keys come from the caller, split per model to that model's own count
(``split`` is not prefix-stable across counts).
"""
from __future__ import annotations

import torch

from .. import rng
from .graphs import CapturedSteps, unflatten
from .losses import (ce_terms, cross_entropy, kd_regularizer,  # noqa: F401
                     kd_terms)


def output_to_model(model_apply, params, seeds_x, seeds_y, gout,
                    iters: int, batch: int, eta, beta, key):
    """K_s iterations of eq. (5) for one server model: ``params`` a
    two-level dict of unstacked leaves (a round-loop model's), seeds_y
    int labels (FLD, Mix2FLD hard labels) or soft label vectors (MixFLD);
    the KD target row is the (arg-max for soft) ground-truth label.
    Step i draws its batch from ``split(key, iters)[i]``, as the
    reference's scan.  ``key`` is required.  Returns (params, losses
    (iters,)).  A G = 1 group of :func:`output_to_model_steps`, on the
    device of ``seeds_x``."""
    dev = seeds_x.device
    new, losses = output_to_model_steps(
        model_apply, {k: {n: t[None] for n, t in v.items()}
                      for k, v in params.items()},
        seeds_x[None], seeds_y[None],
        gout[None], rng.split(key, iters)[None],
        torch.tensor([iters], dtype=torch.int64, device=dev),
        seeds_x.shape[0], batch,
        torch.tensor([eta], dtype=torch.float32, device=dev),
        torch.tensor([beta], dtype=torch.float32, device=dev))
    return {k: {n: t[0] for n, t in v.items()} for k, v in new.items()}, \
        losses[0]


def output_to_model_steps(model_apply, params, seeds_x, seeds_y, gout,
                          step_keys, iters, n_train, batch: int, eta, beta):
    """The masked eq. (5) conversion of G stacked server models:
    ``params`` leaves (G, ...), seeds_x (G, N, ...), seeds_y (G, N) int64
    or (G, N, C) soft, gout (G, C, C), step_keys (G, K_max, 2), ``iters``
    (int64), ``eta`` and ``beta`` (float32) each (G,), and ``n_train``
    an int or a (G,) int64 tensor, below 2**31 (a tensor bound is not
    read back to be checked).  Returns (params, losses (G, K_max)),
    masked steps' losses 0.  A caller that converts every round keeps
    one :class:`OutputToModelSteps` instead, so that its graph is
    captured once."""
    return OutputToModelSteps(model_apply)(
        params, seeds_x, seeds_y, gout, step_keys, iters, n_train, batch,
        eta, beta)


class OutputToModelSteps:
    """:func:`output_to_model_steps` with its static buffers and step
    graph kept between calls, one per input layout.  Every per-model
    value (eta, beta, ``iters``, the batch indices) is an input of the
    step, so one capture serves a whole sweep group and every value of
    them.  Model g's loss is eq. (5) over its batch, the mean of
    ``ce_terms`` plus beta times the mean of ``kd_terms`` (the terms of
    ``cross_entropy`` and ``kd_regularizer``), and its update ``p - eta
    g`` is taken where its step index is below ``iters[g]``.

    Each model runs through ``model_apply`` on its own slice of the
    stacked leaves: on the CPU a grouped convolution over G models is not
    bit-equal to G single ones, and a sweep is held to its loop (G = 1)
    at 1e-6."""

    def __init__(self, model_apply):
        self.model_apply = model_apply
        self.steps = CapturedSteps()

    @property
    def graphs(self):
        return self.steps.graphs

    def _make_step(self, buf):
        model_apply = self.model_apply
        inp, losses, k = buf.inputs, buf.outputs["losses"], buf.k
        hard = not inp["y"].is_floating_point()
        G, _, batch = inp["idx"].shape
        models = torch.arange(G, device=k.device)[:, None]
        # one model's eta is one scalar tensor (a fused multiply), G
        # models' a view per leaf
        eta = (inp["eta"][0] if G == 1 else
               [inp["eta"].view((-1,) + (1,) * (t.dim() - 1))
                for t in buf.leaves])

        def step():
            ik = inp["idx"].index_select(1, k).view(G, batch)
            xb, yb = inp["x"][models, ik], inp["y"][models, ik]
            target = inp["gout"][models, yb if hard else yb.argmax(-1)]
            logits = []
            for g in range(G):
                # model g on views of its slice of the stacked leaves (at
                # G = 1 a view whose gradient is the stacked leaf's own)
                mine = [t.squeeze(0) if G == 1 else t[g]
                        for t in buf.leaves]
                logits.append(model_apply(unflatten(buf.params, mine),
                                          xb[g]))
            logits = torch.stack(logits)                     # (G, B, C)
            # cross_entropy + beta kd_regularizer a model; each term takes
            # its own log_softmax as they do (one shared would change the
            # gradient's rounding)
            loss = (ce_terms(torch.log_softmax(logits, -1), yb).mean(-1)
                    + inp["beta"] * kd_terms(torch.log_softmax(logits, -1),
                                             target).mean(-1))  # (G,)
            grads = torch.autograd.grad(loss.sum(), buf.leaves)
            with torch.no_grad():
                # p - where(live, eta g, 0): a masked step subtracts an
                # exact 0, whatever its gradient holds
                live = k < inp["iters"]                      # (G,)
                upd = torch._foreach_mul(grads, eta)
                torch._foreach_sub_(buf.leaves, [
                    torch.where(live.view((-1,) + (1,) * (u.dim() - 1)),
                                u, 0.0) for u in upd])
                losses.index_copy_(1, k, torch.where(
                    live, loss.detach(), 0.0)[:, None])
                k.add_(1)

        return step

    def __call__(self, params, seeds_x, seeds_y, gout, step_keys, iters,
                 n_train, batch: int, eta, beta):
        G, k_max = step_keys.shape[:2]
        idx = rng.randint(step_keys, (batch,), 0, n_train)  # (G, K_max, B)
        new, out = self.steps(
            self._make_step, params,
            dict(x=seeds_x, y=seeds_y, gout=gout, idx=idx, eta=eta,
                 beta=beta, iters=iters),
            dict(losses=(G, k_max)), k_max)
        return new, out["losses"]
