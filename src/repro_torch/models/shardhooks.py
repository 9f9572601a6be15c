"""Activation-sharding hook.

The model calls ``constrain(x, kind)`` where the reference constrains
its activations' sharding.  On one GPU nothing is installed and it is
the identity; the multi-GPU slice (ROADMAP A13) installs a function
through :func:`set_activation_sharding`.

kinds: resid (B,S,D) | heads (B,S,H,d) | kv (B,S,Hkv,d) | logits (B,S,V)
       scores_seq (B,Hkv,G,T,S) | ssm_inner (B,S,H,P)
"""
from __future__ import annotations

_HOOK = [None]


def set_activation_sharding(fn) -> None:
    _HOOK[0] = fn


def constrain(x, kind: str):
    if _HOOK[0] is None:
        return x
    return _HOOK[0](x, kind)
