"""Server-side output-to-model conversion (eq. 5, Algorithm 1 line 10).

The server transfers the knowledge in the global average output vectors
G_out into the global model by running K_s SGD-with-KD iterations over
the collected (for Mix2FLD, inversely mixed-up) seed samples.  Plain
PyTorch losses, as the reference computes eq. 5 in plain jnp.  On the
GPU the steps are replays of a captured CUDA graph of one step
(``core/graphs.py``); on the CPU the same step runs eagerly.  The
masked grid variant (``output_to_model_steps``) waits for the sweep
engine.
"""
from __future__ import annotations

import torch

from .. import rng
from .graphs import CapturedSteps
from .losses import cross_entropy, kd_regularizer


def output_to_model(model_apply, params, seeds_x, seeds_y, gout,
                    iters: int, batch: int, eta, beta, key):
    """K_s iterations of eq. (5). seeds_y can be int labels (FLD, Mix2FLD)
    or soft label vectors (MixFLD); the KD target row is chosen by the
    (arg-max for soft) label.  ``key`` is required.  Returns (new params,
    losses (iters,)); ``params`` is left untouched.  A caller that
    converts every round keeps one :class:`OutputToModel` instead, so
    that its graph is captured once."""
    return OutputToModel(model_apply)(params, seeds_x, seeds_y, gout, iters,
                                      batch, eta, beta, key)


class OutputToModel:
    """:func:`output_to_model` with its static buffers and step graph kept
    between calls (``core/graphs.py`` :class:`CapturedSteps`), one per
    input layout (and eta, beta), built at first use.  The seeds, the
    batch indices, the parameters and G_out are copied in at each
    call."""

    def __init__(self, model_apply):
        self.model_apply = model_apply
        self.steps = CapturedSteps()

    @property
    def graphs(self):
        return self.steps.graphs

    def _make_step(self, eta, beta):
        model_apply = self.model_apply

        def make(buf):
            inp, losses, k = buf.inputs, buf.outputs["losses"], buf.k
            hard = not inp["y"].is_floating_point()
            batch = inp["idx"].shape[1]

            def step():
                ik = inp["idx"].index_select(0, k).view(batch)
                xb, yb = inp["x"][ik], inp["y"][ik]
                logits = model_apply(buf.params, xb)
                row = yb if hard else yb.argmax(-1)
                loss = cross_entropy(logits, yb) + beta * kd_regularizer(
                    logits, inp["gout"][row])
                grads = torch.autograd.grad(loss, buf.leaves)
                with torch.no_grad():
                    torch._foreach_sub_(buf.leaves,
                                        torch._foreach_mul(grads, eta))
                    losses.index_copy_(0, k, loss.detach()[None])
                    k.add_(1)

            return step

        return make

    def __call__(self, params, seeds_x, seeds_y, gout, iters: int,
                 batch: int, eta, beta, key):
        n = seeds_x.shape[0]
        idx = rng.randint(rng.split(key, iters), (batch,), 0, n)
        new, out = self.steps(
            self._make_step(eta, beta), params,
            dict(x=seeds_x, y=seeds_y, gout=gout, idx=idx),
            dict(losses=(iters,)), iters, key=(eta, beta))
        return new, out["losses"]
