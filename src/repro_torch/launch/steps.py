"""Serving step builders: cache-building prefill and greedy decode, for
the dense (KV cache) and SSM (state and conv cache) families.

The reference's train step, its chunked LM loss and the multi-pod
federated sync steps wait for the training part of ROADMAP A15.
"""
from __future__ import annotations

import torch

from ..models import kvcache
from ..models.transformer import forward


def make_prefill_step(cfg, seq_len: int):
    """tokens (B, S) -> (last-token logits, filled cache of ``seq_len``;
    the SSM cache does not depend on ``seq_len``)."""

    def prefill_step(params, batch):
        tokens = batch["tokens"]
        cache = kvcache.init_cache(cfg, tokens.shape[0], seq_len,
                                   device=tokens.device)
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
