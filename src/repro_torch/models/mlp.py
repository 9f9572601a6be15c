"""Feed-forward blocks: SwiGLU (silu) and the plain GELU MLP.  The
registry's ``MLPClassifier`` waits for ROADMAP A10."""
from __future__ import annotations

from .. import rng
from .layers import act_fn, dense_init, dtype_of


def init_mlp(cfg, key, d_ff=None):
    dt = dtype_of(cfg)
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    k1, k2, k3 = rng.split(key, 3).unbind(0)
    if cfg.mlp_act == "gelu":
        return {"w1": dense_init(k1, D, F, dt), "w2": dense_init(k2, F, D, dt)}
    return {
        "w1": dense_init(k1, D, F, dt),   # up
        "w3": dense_init(k3, D, F, dt),   # gate
        "w2": dense_init(k2, F, D, dt),   # down
    }


def mlp(cfg, p, x):
    act = act_fn(cfg.mlp_act)
    if "w3" in p:  # SwiGLU
        return (act(x @ p["w3"]) * (x @ p["w1"])) @ p["w2"]
    return act(x @ p["w1"]) @ p["w2"]
