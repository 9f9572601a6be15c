"""Server-side output-to-model conversion (eq. 5, Algorithm 1 line 10).

The server transfers the knowledge in the global average output vectors
G_out into the global model by running K_s SGD-with-KD iterations over
the collected (for Mix2FLD, inversely mixed-up) seed samples.  Plain
PyTorch, as the reference computes eq. 5 in plain jnp.  The masked grid
variant (``output_to_model_steps``) waits for the sweep engine.
"""
from __future__ import annotations

import torch

from .. import rng
from .losses import cross_entropy, kd_regularizer


def output_to_model(model_apply, params, seeds_x, seeds_y, gout,
                    iters: int, batch: int, eta, beta, key):
    """K_s iterations of eq. (5). seeds_y can be int labels (FLD, Mix2FLD)
    or soft label vectors (MixFLD); the KD target row is chosen by the
    (arg-max for soft) label.  ``key`` is required.  Returns (new params,
    losses (iters,)); ``params`` is left untouched."""
    hard = not seeds_y.is_floating_point()
    n = seeds_x.shape[0]
    idx = rng.randint(rng.split(key, iters), (batch,), 0, n)
    leaves = [t.detach().clone().requires_grad_(True)
              for v in params.values() for t in v.values()]
    new = _unflatten(params, leaves)
    losses = torch.empty(iters, device=seeds_x.device)
    for k in range(iters):
        xb, yb = seeds_x[idx[k]], seeds_y[idx[k]]
        logits = model_apply(new, xb)
        row = yb if hard else yb.argmax(-1)
        loss = cross_entropy(logits, yb) + beta * kd_regularizer(
            logits, gout[row])
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(eta * g)
            losses[k] = loss.detach()
    return _unflatten(params, [t.detach() for t in leaves]), losses


def _unflatten(like, leaves):
    it = iter(leaves)
    return {k: {n: next(it) for n in v} for k, v in like.items()}
