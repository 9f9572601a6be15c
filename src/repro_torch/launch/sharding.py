"""The sharding rules: the LM family's tensor, FSDP and expert
parallelism over the production meshes (``launch/mesh.py``), and the
federated round loop's placements.

Conventions (mesh dims: optional "pod", "data", "model"), the
reference's:

  * big weight matrices are 2-D sharded: the input-ish dim over "data"
    (FSDP), the output-ish / head / expert dim over "model" (TP);
  * experts shard over "model" when their count divides it, else the
    expert FFN dim does;
  * the batch shards over ("pod", "data");
  * decode KV caches: the batch over ("pod", "data"), the *sequence*
    over "model" (decode attention's scores reduce over the sharded key
    axis);
  * SSM caches: the heads over "model".

A rule gives a :class:`PartitionSpec`, the reference's PartitionSpec
kept as a tuple: one entry a tensor dim, each a mesh dim's name, a tuple
of names, or None, so ``tuple(port_spec) == tuple(ref_spec)`` compares
them entry for entry.  :func:`to_placements` maps a spec on a mesh to
the DTensor placements, one a mesh dim:

  ======================  ==================  ==============================
  spec on the mesh        mesh dims           placements
  ======================  ==================  ==============================
  P("data", "model")      ("data", "model")   (Shard(0), Shard(1))
  P("model", "data")      ("data", "model")   (Shard(1), Shard(0))
  P(("pod","data"), None) ("pod","data",      (Shard(0), Shard(0),
                           "model")            Replicate())
  P()                     any                 Replicate() on every dim
  ======================  ==================  ==============================

A tensor dim that two mesh dims shard (the third row) is split over the
first mesh dim and each part over the second, as jax splits it: DTensor
applies the Shard()s of one tensor dim in mesh-dim order, so the spec's
names must come in the mesh's order.

The rules read only a mesh's dim names and sizes (``mesh_dim_names``,
``shape``): a :class:`~torch.distributed.device_mesh.DeviceMesh`, or any
object with the two.  The dry run (``launch/dryrun.py``) places the
parameters and the batch by them and installs :func:`sharding_hook`
into ``models/shardhooks.py``; on the one-GPU paths no hook is
installed and the model's tensors are plain.

The federated placements (:func:`federated_pspecs`,
:func:`federated_grid_pspecs`) are the layout contract of the sharded
round loop, which the tests hold to the reference's PartitionSpecs.  No
path reads them: the round loop splits its device axis by hand
(``core/protocols.py`` ``GridShards``), one block of rows a rank, and
keeps its replicas equal through deterministic computation, so it has
no DTensor to place.
"""
from __future__ import annotations

import math

from torch.distributed.tensor import Replicate, Shard


class PartitionSpec(tuple):
    """The reference's PartitionSpec: ``P("data", None, ("pod", "data"))``
    is the tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


P = PartitionSpec


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, name: str) -> int:
    return _axis_sizes(mesh).get(name, 1)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _dp(mesh, exclude_pod: bool = False):
    """The batch dims' spec entry: a name, a tuple of names, or None."""
    dp = batch_axes(mesh)
    if exclude_pod:
        dp = tuple(a for a in dp if a != "pod")
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def to_placements(mesh, spec, ndim: int) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` for a tensor of
    ``ndim`` dims: ``Shard(i)`` on each mesh dim that tensor dim ``i``
    names, ``Replicate()`` on the rest."""
    names = tuple(mesh.mesh_dim_names)
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} does not follow the mesh's "
                             f"dim order {names}")
        for j in idx:
            if out[j] != Replicate():
                raise ValueError(f"mesh dim {names[j]!r} named twice in "
                                 f"{spec}")
            out[j] = Shard(i)
    return tuple(out)


def from_placements(mesh, placements, ndim: int) -> PartitionSpec:
    """The spec of ``placements`` on ``mesh`` (the inverse of
    :func:`to_placements`, trailing Nones dropped)."""
    names = tuple(mesh.mesh_dim_names)
    entries: list = [[] for _ in range(ndim)]
    for name, pl in zip(names, placements):
        if isinstance(pl, Shard):
            entries[pl.dim % ndim].append(name)
        elif pl != Replicate():
            raise ValueError(f"placement {pl} is not a Shard or Replicate")
    spec = [None if not e else (e[0] if len(e) == 1 else tuple(e))
            for e in entries]
    while spec and spec[-1] is None:
        spec.pop()
    return P(*spec)


# ---------------------------------------------------------------------------
# Federated round-loop placements (device axis)
# ---------------------------------------------------------------------------

def federated_pspecs() -> dict:
    """Placements on the 1-D ("data",) mesh (``make_device_mesh``):
    ``device`` shards the leading device axis of every per-device operand
    (stacked params, local data, per-round keys, per-device G_out
    tables); ``replicated`` covers scalars and the aggregated tables the
    all-reduces return on every rank."""
    return {"device": (Shard(0),), "replicated": (Replicate(),)}


def federated_grid_pspecs() -> dict:
    """Placements on the 2-D ("grid", "data") mesh (``make_grid_mesh``):

    * ``gdev`` — (G, D, ...) operands: the grid axis over "grid", the
      device axis over "data";
    * ``gcfg`` — (G, ...) per-point values: the grid axis only, whole on
      each "data" shard;
    * ``data`` — (D, ...) operands shared by the grid points: the device
      axis only, whole over "grid";
    * ``replicated`` — true scalars.

    The device-axis sums reduce over "data" only: each grid shard's sum
    spans its own points' device rows."""
    return {"gdev": (Shard(0), Shard(1)),
            "gcfg": (Shard(0), Replicate()),
            "data": (Replicate(), Shard(0)),
            "replicated": (Replicate(), Replicate())}


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

_REPLICATED = ("scale", "bias", "A_log", "D", "dt_bias", "norm", "q_norm",
               "kv_norm", "q_scale", "k_scale", "bq", "bk", "bv")
_COLUMN = ("w1", "w3", "wq", "wk", "wv", "xwq", "xwk", "xwv", "wq_b", "wk_b",
           "wv_b", "in_proj")
_ROW = ("w2", "wo", "xwo", "out_proj")


def _rule_for(cfg, mesh, path: str, ndim: int, shape) -> PartitionSpec:
    """The spec of one (unstacked) parameter, by its path."""
    tp = _axis_size(mesh, "model")
    last = path.split("/")[-1]
    if last in _REPLICATED:          # norms, scalars, small vectors
        return P()
    if last == "pos_embed":
        return P(None, "data")
    if last == "embed":              # (V, D)
        return P("model", "data")
    if last == "unembed":            # (D, V)
        return P("data", "model")
    if last == "router":             # (D, E): tiny
        return P()
    if last == "conv_w":             # (k, Cd)
        return P(None, "model")
    if last == "conv_b":
        return P("model")
    if "moe" in path and last in ("w1", "w2", "w3") and ndim == 3:
        if shape[0] % tp == 0:       # expert parallelism
            return P("model", "data", None)
        # TP inside the experts: the FFN dim
        return (P(None, "data", "model") if last in ("w1", "w3")
                else P(None, "model", "data"))
    if last in _COLUMN:              # column-parallel up
        return P("data", "model")
    if last in _ROW:                 # row-parallel down
        return P("model", "data")
    if last in ("wq_a", "wkv_a"):    # (D, small rank)
        return P("data", None)
    if last in ("w", "b"):           # the paper CNN: never sharded
        return P()
    raise ValueError(f"no sharding rule for {path} (ndim={ndim})")


def sanitize(mesh, spec, shape) -> PartitionSpec:
    """Drop the sharding of every dim its mesh dims do not divide."""
    sizes = _axis_sizes(mesh)
    spec_t = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, ax in zip(shape, spec_t):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        out.append(ax if dim % math.prod(sizes[a] for a in axes) == 0
                   else None)
    return P(*out)


# The reference's budget is 10 GiB of a v5e's 16 GiB of HBM (62.5%) for
# TP-only decode weights.  The same share of the H100's 80 GB (80e9
# bytes) is 50e9 bytes a card, the rest left to the KV cache and the
# activations.
DECODE_TP_BUDGET = int(80e9 * 10 / 16)


def _walk(tree, fn, keys=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, keys + (str(k),)) for k, v in tree.items()}
    return fn(keys, tree)


def param_pspecs(cfg, mesh, params_tree, decode_tp: bool = False):
    """The spec tree of a parameter tree (tensors, or anything with
    ``shape``).  Leaves under ``blocks`` get a leading None for the
    stacked layer dim, two for the hybrid's (G, A) stacking.

    ``decode_tp``: drop the FSDP ("data") dim from every weight: decode
    reads each weight once a token, so gathering it over "data" a layer
    costs more than holding the TP shard whole.  :func:`use_decode_tp`
    gates it by the budget."""

    def visit(keys, leaf):
        shape = tuple(leaf.shape)
        stacked = 0
        if "blocks" in keys:
            stacked = 2 if cfg.family == "hybrid" else 1
        spec = _rule_for(cfg, mesh, "/".join(keys), len(shape) - stacked,
                         shape[stacked:])
        if decode_tp:
            spec = P(*(None if a == "data" else a for a in spec))
        return sanitize(mesh, P(*((None,) * stacked + tuple(spec))), shape)

    return _walk(params_tree, visit)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def use_decode_tp(cfg, mesh, params_tree,
                  budget: int = DECODE_TP_BUDGET) -> bool:
    """TP-only decode weights iff a card's TP share fits ``budget``."""
    total = sum(math.prod(leaf.shape) * leaf.dtype.itemsize
                for leaf in _leaves(params_tree))
    return total / _axis_size(mesh, "model") <= budget


# ---------------------------------------------------------------------------
# Batch / cache rules
# ---------------------------------------------------------------------------

def batch_pspecs(cfg, mesh, specs: dict) -> dict:
    """The specs of an ``input_specs()`` dict (train, prefill or decode),
    sanitized against its shapes."""
    dp = _dp(mesh)
    out = {}
    for k, v in specs.items():
        if k == "cache":
            raw = cache_pspecs(cfg, mesh)
            out[k] = {"pos": raw["pos"]}
            for group, leaves in v.items():
                if group != "pos":
                    out[k][group] = {n: sanitize(mesh, raw[group][n], t.shape)
                                     for n, t in leaves.items()}
        elif k == "gout":
            out[k] = P()
        elif k in ("tokens", "labels"):
            out[k] = sanitize(mesh, P(dp, None), v.shape)
        elif k in ("embeds", "enc_out"):
            out[k] = sanitize(mesh, P(dp, None, None), v.shape)
        else:
            raise ValueError(k)
    return out


def cache_pspecs(cfg, mesh) -> dict:
    dp = _dp(mesh)
    out: dict = {"pos": P()}
    if cfg.family in ("dense", "vlm", "moe", "audio"):
        if cfg.attn_type == "mla":
            lay = {"ckv": P(None, dp, "model", None),
                   "kr": P(None, dp, "model", None)}
        else:
            lay = {"k": P(None, dp, "model", None, None),
                   "v": P(None, dp, "model", None, None)}
            if cfg.kv_quant:
                lay["k_scale"] = P(None, dp, "model", None)
                lay["v_scale"] = P(None, dp, "model", None)
        if cfg.family == "audio":
            lay["xk"] = P(None, dp, None, "model", None)
            lay["xv"] = P(None, dp, None, "model", None)
        out["layers"] = lay
    elif cfg.family == "ssm":
        out["layers"] = {"state": P(None, dp, "model", None, None),
                         "conv": P(None, dp, None, "model")}
    elif cfg.family == "hybrid":
        out["mamba"] = {"state": P(None, None, dp, "model", None, None),
                        "conv": P(None, None, dp, None, "model")}
        out["attn"] = {"k": P(None, dp, "model", None, None),
                       "v": P(None, dp, "model", None, None)}
    return out


# ---------------------------------------------------------------------------
# Activation constraints (installed into models/shardhooks.py)
# ---------------------------------------------------------------------------

def _place(mesh, x, spec):
    """``x`` redistributed to ``spec``; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, to_placements(mesh, spec, x.ndim))


def logical_constraints(cfg, mesh, exclude_pod: bool = False):
    """``constrain(x, kind)`` for the MoE dispatch: ``combine`` (G, Sg,
    E, C) keeps its tokens on the batch dims; ``dispatched`` (G, E, C, D)
    is expert-parallel when the experts divide "model", else sharded on
    D."""
    dp = _dp(mesh, exclude_pod)
    tp = _axis_size(mesh, "model")
    ep = cfg.num_experts % tp == 0 if cfg.is_moe else False

    def constrain_moe(x, kind="dispatched"):
        if kind == "combine":
            spec = P(dp, None, None, None)
        else:
            spec = (P(dp, "model", None, None) if ep
                    else P(dp, None, None, "model"))
        return _place(mesh, x, spec)

    return constrain_moe


def activation_constrainer(cfg, mesh, exclude_pod: bool = False):
    """``constrain(x, kind)``: pins the batch dim (and the head and state
    dims where "model" divides them) of the model's activations.

    ``exclude_pod``: for the FD sync's conversion, each pod's replica
    runs on its own pod, so its activations never claim the pod dim."""
    dp = _dp(mesh, exclude_pod)
    tp = _axis_size(mesh, "model")

    def head_axis(n):
        return "model" if (n and n % tp == 0) else None

    h_ax = head_axis(cfg.num_heads)
    kv_ax = head_axis(cfg.num_kv_heads)
    ssm_ax = head_axis(cfg.ssm_heads)
    specs = {"heads": P(dp, None, h_ax, None),
             "kv": P(dp, None, kv_ax, None),
             "logits": P(dp, None, "model"),
             "ssm_inner": P(dp, None, ssm_ax, None),
             "ssm_state": P(dp, ssm_ax, None, None)}

    def constrain(x, kind):
        if kind == "scores_seq":
            # (B, Hkv, G, T, S) decode scores: the key dim over "model"
            if x.ndim != 5 or x.shape[-1] % tp or x.shape[-2] != 1:
                return x
            return _place(mesh, x, P(dp, None, None, None, "model"))
        if kind == "resid":
            if x.ndim != 3:
                return x
            if x.shape[1] == 1:
                # decode: the one token's activations whole, so the
                # products contract against the weights where they lie
                spec = P(None, None, None)
            else:
                # sequence-parallel residual stream
                spec = P(dp, "model" if x.shape[1] % tp == 0 else None,
                         None)
        else:
            spec = specs.get(kind)
            if spec is None or x.ndim != len(spec):
                return x
        return _place(mesh, x, spec)

    return constrain


def sharding_hook(cfg, mesh, exclude_pod: bool = False):
    """The one function ``models/shardhooks.py`` calls: ``combine`` and
    ``dispatched`` go to :func:`logical_constraints`, every other kind to
    :func:`activation_constrainer`."""
    moe = logical_constraints(cfg, mesh, exclude_pod)
    act = activation_constrainer(cfg, mesh, exclude_pod)

    def constrain(x, kind):
        if kind in ("combine", "dispatched"):
            return moe(x, kind)
        return act(x, kind)

    return constrain
