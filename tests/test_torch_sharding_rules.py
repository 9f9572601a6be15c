"""The port's LM sharding rules (``launch/sharding.py``), its dry-run
input specs (``configs.input_specs``, ``kvcache.cache_specs``) and its
counts (``launch/dryrun.py``) against the reference's, called live.

Every assigned architecture x every input shape it supports x the
16 x 16, 2 x 16 x 16 and 1 x 1 meshes.  The meshes are stand-ins with
the dim names and sizes both sides read (the reference's
``axis_names`` / ``devices.shape``, the port's ``mesh_dim_names`` /
``shape``): a 512-device jax mesh cannot start in this process.  The
reference's parameter trees are ``jax.eval_shape`` of its
``init_params``, once an architecture; the port's are its meta-device
trees.  Specs are compared entry for entry (``tuple(spec)``); counts
exactly.
"""
import functools
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch import configs
from repro_torch.launch import dryrun, sharding as shp
from repro_torch.roofline import analysis
from test_torch_reference import load_reference

ARCHS = configs.list_archs(assigned_only=True)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


def _mesh(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(axis_names=names, mesh_dim_names=names,
                                 shape=shape,
                                 devices=types.SimpleNamespace(shape=shape))


def _ref_cfg(name):
    return load_reference().configs.get_config(name)


def _ref_input_specs(rcfg, shape):
    """The reference's ``input_specs``: its lazy ``from repro.models
    import kvcache`` finds the loader's module (a fresh import of
    ``repro.models`` would meet ROADMAP C1)."""
    ref = load_reference()
    pkg = types.ModuleType("repro")
    models = types.ModuleType("repro.models")
    models.kvcache, pkg.models = ref.kvcache, models
    saved = {k: sys.modules.get(k) for k in ("repro", "repro.models")}
    sys.modules.update({"repro": pkg, "repro.models": models})
    try:
        return ref.configs.input_specs(rcfg, shape)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    """The reference's parameter tree of ``name`` as ShapeDtypeStructs."""
    return load_reference().dryrun.param_specs(_ref_cfg(name))


@functools.lru_cache(maxsize=None)
def _port_params(name):
    return dryrun.param_specs(configs.get_config(name))


def _shapes(name):
    cfg = configs.get_config(name)
    return [s for s in configs.INPUT_SHAPES if cfg.supports_shape(s)]


def _flat(tree, prefix=()):
    """((path, leaf), ...) of a nested dict, sorted keys."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                      prefix + (k,))]
    return [(prefix, tree)]


def _same_specs(got, want):
    """Two spec trees: the same paths, each spec the same entries."""
    g, w = _flat(got), _flat(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert tuple(a) == tuple(b), (path, a, b)


def _dtype(d) -> str:
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


@pytest.mark.parametrize("name", ARCHS)
def test_param_trees_match_reference(name):
    """The meta-device tree (nothing drawn) has the reference's paths,
    shapes and dtypes (``jax.eval_shape``), and the same counts."""
    ref = load_reference()
    got, want = _port_params(name), _ref_params(name)
    g, w = _flat(got), _flat(jax.tree.map(lambda x: x, want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, t), (_, s) in zip(g, w):
        assert t.is_meta, path
        assert tuple(t.shape) == tuple(s.shape), path
        assert _dtype(t.dtype) == _dtype(s.dtype), path
    cfg, rcfg = configs.get_config(name), _ref_cfg(name)
    assert dryrun.count_from_specs(got) == \
        ref.dryrun.count_from_specs(want)
    assert dryrun.active_count_from_specs(cfg, got) == \
        ref.dryrun.active_count_from_specs(rcfg, want)


@pytest.mark.parametrize("name", ARCHS)
def test_model_and_analytic_flops_match_reference(name):
    ref = load_reference()
    cfg, rcfg = configs.get_config(name), _ref_cfg(name)
    n = dryrun.active_count_from_specs(cfg, _port_params(name))
    for shape in configs.INPUT_SHAPES:
        assert dryrun.model_flops(cfg, _port_params(name), shape) == \
            ref.dryrun.model_flops(rcfg, _ref_params(name), shape), shape
        assert analysis.analytic_flops(
            cfg, configs.INPUT_SHAPES[shape], n) == \
            ref.roofline.analytic_flops(
                rcfg, ref.configs.INPUT_SHAPES[shape], n), shape


@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_match_reference(name):
    """Every input of every shape's step: the reference's keys, shapes
    and dtypes (the cache and its ``pos`` too), as meta tensors
    (tests/test_model_registry.py's input_specs cases, which the
    reference cannot collect under the installed jax)."""
    ref = load_reference()
    cfg, rcfg = configs.get_config(name), _ref_cfg(name)
    for shape in configs.INPUT_SHAPES:
        got = configs.input_specs(cfg, shape)
        want = _ref_input_specs(rcfg, shape)
        g, w = _flat(got), _flat(want)
        assert [p for p, _ in g] == [p for p, _ in w], shape
        for (path, t), (_, s) in zip(g, w):
            assert t.is_meta, (shape, path)
            assert tuple(t.shape) == tuple(s.shape), (shape, path)
            assert _dtype(t.dtype) == _dtype(s.dtype), (shape, path)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_rules_match_reference(name, mesh):
    """``param_pspecs`` (``decode_tp`` off and on), ``use_decode_tp`` at
    the reference's budget, ``batch_pspecs`` and ``cache_pspecs`` for
    every shape the architecture supports."""
    ref = load_reference()
    m = _mesh(mesh)
    cfg, rcfg = configs.get_config(name), _ref_cfg(name)
    got_p, want_p = _port_params(name), _ref_params(name)
    for tp in (False, True):
        _same_specs(shp.param_pspecs(cfg, m, got_p, decode_tp=tp),
                    ref.sharding.param_pspecs(rcfg, m, want_p,
                                              decode_tp=tp))
    assert shp.use_decode_tp(cfg, m, got_p,
                             budget=ref.sharding.DECODE_TP_BUDGET) == \
        ref.sharding.use_decode_tp(rcfg, m, want_p)
    assert shp.batch_axes(m) == ref.sharding.batch_axes(m)
    _same_specs(shp.cache_pspecs(cfg, m), ref.sharding.cache_pspecs(rcfg, m))
    for shape in _shapes(name):
        _same_specs(
            shp.batch_pspecs(cfg, m, configs.input_specs(cfg, shape)),
            ref.sharding.batch_pspecs(rcfg, m,
                                      _ref_input_specs(rcfg, shape)))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sanitize_matches_reference(mesh):
    ref = load_reference()
    m = _mesh(mesh)
    entries = [None, "data", "model", ("pod", "data")] if mesh == "2x16x16" \
        else [None, "data", "model", ("data", "model")]
    rs = np.random.default_rng(0)
    for _ in range(200):
        nd = int(rs.integers(1, 5))
        shape = tuple(int(s) for s in rs.choice([1, 2, 14, 16, 32, 48, 512],
                                                nd))
        spec = [entries[int(i)] for i in rs.integers(0, 4, int(
            rs.integers(0, nd + 1)))]
        named = [a for e in spec if e
                 for a in (e if isinstance(e, tuple) else (e,))]
        if len(set(named)) < len(named):
            continue   # a mesh dim named twice: no spec of either side
        got = shp.sanitize(m, shp.P(*spec), shape)
        want = ref.sharding.sanitize(m, ref.sharding.P(*spec), shape)
        assert tuple(got) == tuple(want), (spec, shape)


def _shape(*dims):
    return types.SimpleNamespace(ndim=len(dims), shape=tuple(dims))


def _kinds(cfg):
    """(kind, shape) pairs for every kind the model constrains, the
    decode ``resid`` and ``scores_seq`` branches, the ndim guards and an
    unknown kind."""
    H, Hkv = cfg.num_heads, max(cfg.num_kv_heads, 1)
    out = [("resid", _shape(4, 1, 64)), ("resid", _shape(32, 4096, 64)),
           ("resid", _shape(32, 40, 64)), ("resid", _shape(32, 40)),
           ("heads", _shape(32, 64, H, 8)), ("kv", _shape(32, 64, Hkv, 8)),
           ("heads", _shape(32, 64, H)), ("logits", _shape(32, 64, 512)),
           ("ssm_inner", _shape(32, 64, max(cfg.ssm_heads, 1), 8)),
           ("ssm_state", _shape(32, max(cfg.ssm_heads, 1), 16, 8)),
           ("scores_seq", _shape(32, Hkv, 2, 1, 4096)),
           ("scores_seq", _shape(32, Hkv, 2, 1, 4000)),
           ("scores_seq", _shape(32, Hkv, 2, 8, 4096)),
           ("scores_seq", _shape(32, 4096)),
           ("combine", _shape(64, 512, 60, 44)),
           ("dispatched", _shape(64, 60, 44, 2048)),
           ("elsewhere", _shape(4, 4))]
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_constraints_match_reference(mesh, monkeypatch):
    """The spec each kind is constrained to (or none), for every
    architecture, with and without ``exclude_pod``: the reference's
    ``NamedSharding`` and ``with_sharding_constraint`` patched to hand
    the spec back, the port's placement step likewise; the port's one
    hook sends ``combine``/``dispatched`` to the MoE constraints."""
    ref = load_reference()
    m = _mesh(mesh)
    monkeypatch.setattr(ref.sharding, "NamedSharding",
                        lambda mesh, spec: ("spec", tuple(spec)))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: s)
    monkeypatch.setattr(shp, "_place", lambda mesh, x, spec:
                        ("spec", tuple(spec)))
    for name in ARCHS:
        cfg, rcfg = configs.get_config(name), _ref_cfg(name)
        for ex in (False, True):
            hook = shp.sharding_hook(cfg, m, exclude_pod=ex)
            act = ref.sharding.activation_constrainer(rcfg, m, exclude_pod=ex)
            moe = ref.sharding.logical_constraints(rcfg, m, exclude_pod=ex)
            for kind, x in _kinds(cfg):
                want = (moe(x, kind) if kind in ("combine", "dispatched")
                        else act(x, kind))
                got = hook(x, kind)
                assert got == want, (name, ex, kind, x.shape, got, want)
                assert (got is x) == (want is x)


def test_constraints_leave_plain_tensors_alone():
    """With a hook installed, a plain (not sharded) tensor comes back as
    it is: the one-GPU paths are unchanged."""
    cfg = configs.get_config("qwen2-moe-a2.7b")
    hook = shp.sharding_hook(cfg, _mesh("16x16"))
    x = torch.zeros(32, 64, 16, 8)
    for kind in ("heads", "kv", "resid", "combine", "dispatched",
                 "ssm_state", "logits"):
        assert hook(x, kind) is x


def test_placements_of_specs():
    """A spec's placements: ``Shard(i)`` on the mesh dims tensor dim i
    names, two mesh dims on one tensor dim in the mesh's order, and
    back; a spec whose names break the mesh's order, or name a mesh dim
    twice, raises."""
    m = _mesh("2x16x16")
    cases = {
        shp.P(("pod", "data"), None): (Shard(0), Shard(0), Replicate()),
        shp.P("data", "model"): (Replicate(), Shard(0), Shard(1)),
        shp.P("model", "data"): (Replicate(), Shard(1), Shard(0)),
        shp.P(None, ("pod", "data"), "model"): (Shard(1), Shard(1),
                                                Shard(2)),
        shp.P(): (Replicate(),) * 3,
    }
    for spec, want in cases.items():
        got = shp.to_placements(m, spec, 3)
        assert got == want, spec
        back = tuple(spec)
        while back and back[-1] is None:
            back = back[:-1]
        assert tuple(shp.from_placements(m, got, 3)) == back, spec
    for bad in (shp.P(("data", "pod")), shp.P("data", "data")):
        with pytest.raises(ValueError):
            shp.to_placements(m, bad, 2)
    assert repr(shp.P("data", None)) == "P('data', None)"


def test_decode_tp_budget_is_the_cards():
    """The budget is the reference's share of a chip (10 of 16 GiB) of
    the H100's 80 GB: deepseek-v2's 236B bf16 weights over 16 ranks
    (29.5 GB a card) decode TP-only on the card, not on the v5e."""
    ref = load_reference()
    assert shp.DECODE_TP_BUDGET == int(80e9 * 10 / 16)
    assert ref.sharding.DECODE_TP_BUDGET == 10 * 2 ** 30
    name = "deepseek-v2-236b"
    m = _mesh("16x16")
    assert shp.use_decode_tp(configs.get_config(name), m, _port_params(name))
    assert not ref.sharding.use_decode_tp(_ref_cfg(name), m,
                                          _ref_params(name))


def test_skipped_record_matches_reference():
    """A ``long_500k`` record of a dense full-attention architecture is
    the reference's ``skipped`` record (no world is started for it)."""
    ref = load_reference()
    for name in ("qwen2-0.5b", "deepseek-v2-236b"):
        assert dryrun.dry_run_combo(name, "long_500k", False, save=False,
                                    verbose=False) == \
            ref.dryrun.dry_run_combo(name, "long_500k", False, save=False,
                                     verbose=False)
