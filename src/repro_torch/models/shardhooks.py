"""Activation-sharding hook, and the cache write of a sharded cache.

The model calls ``constrain(x, kind)`` where the reference constrains
its activations' sharding.  On one GPU nothing is installed and it is
the identity; the LM sharding rules install one function through
:func:`set_activation_sharding` (``launch/sharding.py::sharding_hook``,
installed by the dry run's ``build``), which redistributes a DTensor to
the kind's placements and leaves a plain tensor as it is.

:func:`write_slots` is the decode's cache write for a DTensor cache:
DTensor has no strategy for an in-place indexed write into a dim that
is sharded (the key positions over "model"), so each rank writes the
slots that fall in its own block, as a sharded dynamic-update-slice
does.

kinds: resid (B,S,D) | heads (B,S,H,d) | kv (B,S,Hkv,d) | logits (B,S,V)
       scores_seq (B,Hkv,G,T,S) | ssm_inner (B,S,H,P)
       combine (G,Sg,E,C) | dispatched (G,E,C,D)  (the MoE dispatch)
"""
from __future__ import annotations

_HOOK = [None]


def set_activation_sharding(fn) -> None:
    _HOOK[0] = fn


def constrain(x, kind: str):
    if _HOOK[0] is None:
        return x
    return _HOOK[0](x, kind)


def write_slots(cache, new, slots):
    """``cache[b, slots[b, t]] = new[b, t]`` in place for a DTensor
    ``cache`` (B, Sc, ...): ``new`` (B, T, ...) is redistributed to the
    cache's placements with its slot dim whole, and each rank writes,
    into its own block of batch rows and slots, the values whose slot
    lies in it (a slot outside is written back with its own value).
    ``slots``: (B, T) int, plain or replicated.  Returns ``cache``."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, place = cache.device_mesh, cache.placements
    whole = [Replicate()] * mesh.ndim
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, whole, run_check=False)
    if isinstance(slots, DTensor):
        slots = slots.redistribute(mesh, whole).to_local()
    new = new.redistribute(mesh, tuple(Replicate() if p == Shard(1) else p
                                       for p in place)).to_local()
    (bl, sl), (b0, s0) = (
        t[:2] for t in compute_local_shape_and_global_offset(
            cache.shape, mesh, place))
    local = cache.to_local()
    rel = slots[b0:b0 + bl].long() - s0                   # (bl, T)
    inside = ((rel >= 0) & (rel < sl)).reshape(
        rel.shape + (1,) * (new.dim() - 2))
    idx = rel.clamp(0, sl - 1)
    b_idx = torch.arange(bl, device=idx.device)[:, None].expand_as(idx)
    local[b_idx, idx] = torch.where(inside, new.to(local.dtype),
                                    local[b_idx, idx])
    return cache
