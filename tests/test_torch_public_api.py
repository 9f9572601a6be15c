"""The reference's public functions in the port, and the port's cover of
every public name of the reference.

* ``channel.model.simulate_link`` / ``round_trip``,
  ``channel.payload.payload_bits``, ``channel.pipeline.channel_stage``,
  ``core.conversion.output_to_model``,
  ``core.privacy.gaussian_mechanism_tree`` and
  ``data.pipeline.device_batches`` / ``global_batches`` against the
  reference on seeded inputs: the same draws (the port's ``rng`` is the
  reference's threefry), link outcomes and slots equal, latency within
  rtol 1e-6, the conversion within 1e-5, the mechanism within 1e-6.
* For every module of ``src/repro`` (read with ``ast``, nothing of the
  reference imported), each public top-level name (a def, a class, an
  assignment, or a name imported from the package, so a re-export) is
  defined or re-exported by the port's module of the same path, or
  :data:`COUNTERPARTS` names the port's counterpart of a name bound to
  JAX or the TPU, which the test imports.
"""
import ast
import dataclasses
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.channel import ChannelConfig, payload_bits, round_trip
from repro_torch.channel import simulate_link
from repro_torch.channel.model import round_trip_traced
from repro_torch.channel.pipeline import channel_stage
from repro_torch.core.conversion import output_to_model
from repro_torch.core.privacy import gaussian_mechanism_tree
from repro_torch.data import device_batches
from repro_torch.data.pipeline import global_batches
from repro_torch.models import CNN
from repro_torch.models.cnn import from_jax_params, to_jax_params
from test_torch_reference import load_reference
from test_torch_reference import one_thread_per_module  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
REF_ROOT = ROOT / "src" / "repro"

# ---------------------------------------------------------------------------
# The functions, against the reference
# ---------------------------------------------------------------------------

LINKS = [(3, 23.0, 4.0e5, True, 10), (4, 15.0, 1.2e6, True, 6),
         (5, 40.0, 2.5e6, False, 10), (6, 23.0, 1.0e3, False, 3)]


def _channels(p_up_dbm, num_devices):
    kw = dict(num_devices=num_devices, p_up_dbm=p_up_dbm)
    return ChannelConfig(**kw), load_reference().channel.ChannelConfig(**kw)


@pytest.mark.parametrize("seed,p_up,bits,up,n", LINKS)
def test_simulate_link_matches_reference(seed, p_up, bits, up, n):
    ch, ref_ch = _channels(p_up, n)
    t, ok = simulate_link(rng.PRNGKey(seed), ch, bits, up, n)
    rt, rok = load_reference().channel_model.simulate_link(
        jax.random.PRNGKey(seed), ref_ch, bits, up, n)
    np.testing.assert_array_equal(t.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))


@pytest.mark.parametrize("seed,p_up,up_bits,dn_bits,n", [
    (0, 23.0, 4.0e5, 2.0e6, 10), (1, 15.0, 1.5e6, 3.0e6, 5),
    (2, 10.0, 5.0e6, 5.0e6, 8), (3, 40.0, 1.0e3, 1.0e3, 4)])
def test_round_trip_matches_reference(seed, p_up, up_bits, dn_bits, n):
    ch, ref_ch = _channels(p_up, n)
    got = round_trip(rng.PRNGKey(seed), ch, up_bits, dn_bits)
    want = load_reference().channel_model.round_trip(
        jax.random.PRNGKey(seed), ref_ch, up_bits, dn_bits)
    assert set(got) == set(want)
    for k in ("up_ok", "dn_ok", "t_up", "t_dn"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert isinstance(got["latency_s"], float)
    np.testing.assert_allclose(got["latency_s"], want["latency_s"],
                               rtol=1e-6)


def test_round_trip_is_the_traced_draw_and_channel_stage_is_it():
    ch = ChannelConfig(num_devices=6, p_up_dbm=15.0)
    p_up, b_up = ch.link_budget(True)
    p_dn, b_dn = ch.link_budget(False)
    up_bits, dn_bits = 1.5e6, 3.0e6
    got = round_trip(rng.PRNGKey(9), ch, up_bits, dn_bits)
    traced = round_trip_traced(
        rng.PRNGKey(9), p_up, max(1, int(np.ceil(up_bits / b_up))), p_dn,
        max(1, int(np.ceil(dn_bits / b_dn))), 6, ch.t_max_slots, ch.tau_s)
    for k in ("up_ok", "dn_ok", "t_up", "t_dn"):
        assert torch.equal(got[k], traced[k]), k
    np.testing.assert_allclose(got["latency_s"], float(traced["latency_s"]),
                               rtol=1e-6)
    assert channel_stage is round_trip_traced
    assert load_reference().pipeline.channel_stage is \
        load_reference().channel_model.round_trip_traced


@pytest.mark.parametrize("protocol", ["fl", "fd", "fld", "mixfld",
                                      "mix2fld"])
@pytest.mark.parametrize("codec", ["identity", "quantize8", "delta",
                                   "dp_gaussian1.0"])
def test_payload_bits_match_reference(protocol, codec):
    ref = load_reference().payload
    kw = dict(n_mod=123456, n_labels=10, sample_bits=6272, n_seed=10,
              codec=codec)
    for first in (False, True):
        assert payload_bits(protocol, first_round=first, **kw) == \
            ref.payload_bits(protocol, first_round=first, **kw)


@pytest.mark.parametrize("seed,n_local,iters,batch", [
    (0, 500, 7, 16), (11, 37, 3, 32), (12, 2 ** 17 + 5, 2, 8)])
def test_device_batches_match_reference(seed, n_local, iters, batch):
    got = device_batches(rng.PRNGKey(seed), n_local, iters, batch)
    want = load_reference().data.device_batches(
        jax.random.PRNGKey(seed), n_local, iters, batch)
    assert tuple(got.shape) == (iters, batch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_global_batches_match_reference():
    gen = np.random.default_rng(0)
    x = gen.normal(size=(53, 6)).astype(np.float32)
    y = gen.integers(0, 10, size=53).astype(np.int32)
    got = list(global_batches(rng.PRNGKey(4), torch.tensor(x),
                              torch.tensor(y), 9, 5))
    want = list(load_reference().data_pipeline.global_batches(
        jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(y), 9, 5))
    assert len(got) == len(want) == 5
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


@pytest.mark.parametrize("labels", ["hard", "soft"])
def test_output_to_model_matches_reference(labels):
    """K_s eq. (5) steps of the paper CNN on a seeded seed set: params and
    the loss of every step within 1e-5 of the reference's scan."""
    ref = load_reference()
    gen = np.random.default_rng(1)
    n, c, iters, batch = 40, 10, 6, 8
    x = gen.uniform(size=(n, 28, 28, 1)).astype(np.float32)
    y = gen.integers(0, c, size=n).astype(np.int32)
    if labels == "soft":
        y = np.eye(c, dtype=np.float32)[y] * 0.7 + 0.03
    logits = gen.normal(size=(c, c)).astype(np.float32)
    gout = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ref_model = ref.cnn.CNN()
    p0 = jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(3)))
    want_p, want_l = ref.conversion.output_to_model(
        ref_model.apply, p0, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(gout), iters, batch, 0.05, 0.3, jax.random.PRNGKey(5))
    yt = torch.tensor(y) if labels == "soft" else \
        torch.tensor(y, dtype=torch.int64)
    got_p, got_l = output_to_model(
        CNN().apply, from_jax_params(p0), torch.tensor(x), yt,
        torch.tensor(gout), iters, batch, 0.05, 0.3, rng.PRNGKey(5))
    assert tuple(got_l.shape) == (iters,)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=0,
                               atol=1e-5)
    got_np = to_jax_params(got_p)
    for name, leaf in jax.tree.map(np.asarray, want_p).items():
        for k, w in leaf.items():
            np.testing.assert_allclose(got_np[name][k], w, rtol=0,
                                       atol=1e-5, err_msg=f"{name}/{k}")


@pytest.mark.parametrize("sigma,clip", [(1.0, 0.5), (0.3, 50.0)])
def test_gaussian_mechanism_tree_matches_reference(sigma, clip):
    """The global clip over the leaves (binding at clip 0.5, not at 50)
    and each leaf's noise from fold_in(key, i) in sorted-key order."""
    gen = np.random.default_rng(2)
    tree = {"b": {"w": gen.normal(size=(3, 4)).astype(np.float32),
                  "b": gen.normal(size=(4,)).astype(np.float32)},
            "a": {"w": gen.normal(size=(2, 2, 1, 3)).astype(np.float32)},
            "c": {"z": gen.normal(size=(5,)).astype(np.float32)}}
    got = gaussian_mechanism_tree(
        {k: {n: torch.tensor(v) for n, v in d.items()}
         for k, d in tree.items()}, rng.PRNGKey(8), sigma, clip)
    want = load_reference().privacy.gaussian_mechanism_tree(
        jax.tree.map(jnp.asarray, tree), jax.random.PRNGKey(8), sigma, clip)
    assert set(got) == set(tree)
    for k, d in tree.items():
        assert set(got[k]) == set(d)
        for n in d:
            np.testing.assert_allclose(got[k][n].numpy(),
                                       np.asarray(want[k][n]), rtol=0,
                                       atol=1e-6, err_msg=f"{k}/{n}")


# ---------------------------------------------------------------------------
# Every public name of the reference has a port counterpart
# ---------------------------------------------------------------------------

# (reference module path, name) -> (port counterpart "module:attr" or a
# module, why the name itself is not in the port): the names bound to
# JAX, Pallas or the TPU
_WRAPPERS = {"mixup_pallas": "repro_torch.kernels.mixup_kernel:mixup",
             "distill_loss_pallas":
                 "repro_torch.kernels.distill_loss:distill_loss",
             "flash_attention_pallas":
                 "repro_torch.kernels.flash_attention:flash_attention",
             "ssd_scan_pallas": "repro_torch.kernels.ssd_scan:ssd_scan"}
_PALLAS = "a Pallas kernel: the port's wrapper launches its CUDA kernel"
_BLOCK = ("a Pallas block shape: the CUDA kernel sets its own tiles in "
          "csrc/")
_MIXUP_BATCH = ("repro_torch.core.mixup:make_mixup_batch_kernel",
                "the Mixup batch through the Pallas kernel: the port's "
                "runs the CUDA kernel")
_GRID_TRAIN = ("repro_torch.core.protocols:GridRoundStep",
               "a shard_map'd local train: the port's GridRoundStep / "
               "LocalTrain run a sweep group's stacked rows")
_MOE_HOOK = ("repro_torch.launch.sharding:sharding_hook",
             "a GSPMD constraint hook: the port's sharding_hook places "
             "DTensors")
_ICI = ("repro_torch.launch.mesh:NVLINK_BW",
        "a TPU ICI link rate: the H100's link rate, beside the "
        "roofline's terms")
COUNTERPARTS = {
    **{("kernels/ops.py", n): (t, _PALLAS) for n, t in _WRAPPERS.items()},
    ("kernels/mixup_kernel.py", "mixup_pallas"): (_WRAPPERS["mixup_pallas"],
                                                  _PALLAS),
    ("kernels/mixup_kernel.py", "ROW_BLOCK"): (
        "repro_torch.kernels.mixup_kernel:KERNEL", _BLOCK),
    ("kernels/mixup_kernel.py", "COL_BLOCK"): (
        "repro_torch.kernels.mixup_kernel:KERNEL", _BLOCK),
    ("kernels/distill_loss.py", "distill_loss_pallas"): (
        _WRAPPERS["distill_loss_pallas"], _PALLAS),
    ("kernels/distill_loss.py", "ROW_BLOCK"): (
        "repro_torch.kernels.distill_loss:LOSS", _BLOCK),
    ("kernels/flash_attention.py", "flash_attention_pallas"): (
        _WRAPPERS["flash_attention_pallas"], _PALLAS),
    ("kernels/flash_attention.py", "Q_BLOCK"): (
        "repro_torch.kernels.flash_attention:KERNEL", _BLOCK),
    ("kernels/flash_attention.py", "KV_BLOCK"): (
        "repro_torch.kernels.flash_attention:KERNEL", _BLOCK),
    ("kernels/flash_attention.py", "NEG_INF"): (
        "repro_torch.kernels.flash_attention:KERNEL",
        "the Pallas kernel's mask value: the CUDA kernel masks in csrc/"),
    ("kernels/ssd_scan.py", "ssd_scan_pallas"): (
        _WRAPPERS["ssd_scan_pallas"], _PALLAS),
    ("kernels/runtime.py", "default_interpret"): (
        "repro_torch.kernels.runtime:on_cuda",
        "Pallas interpret mode: a CUDA tensor launches the kernel, a CPU "
        "tensor takes the plain version"),
    ("kernels/ref.py", "mixup_ref"): (
        "repro_torch.kernels.mixup_kernel:mixup_plain", "a jnp oracle"),
    ("kernels/ref.py", "distill_loss_ref"): (
        "repro_torch.kernels.distill_loss:distill_loss_plain",
        "a jnp oracle"),
    ("kernels/ref.py", "attention_ref"): (
        "repro_torch.kernels.flash_attention:attention_plain",
        "a jnp oracle"),
    ("kernels/ref.py", "ssd_ref"): (
        "repro_torch.kernels.ssd_scan:ssd_scan_plain", "a jnp oracle"),
    ("kernels/ref.py", "ssd_chunked"): (
        "repro_torch.models.mamba2:ssd_chunked",
        "the reference's chunked SSD, imported as an oracle"),
    ("kernels/ref.py", "ssd_chunked_ref"): (
        "repro_torch.models.mamba2:ssd_chunked", "a jnp oracle"),
    ("core/__init__.py", "make_mixup_batch_pallas"): _MIXUP_BATCH,
    ("core/mixup.py", "make_mixup_batch_pallas"): _MIXUP_BATCH,
    ("core/mixup.py", "mixup_pallas"): (_WRAPPERS["mixup_pallas"], _PALLAS),
    ("core/seed_prep.py", "make_mixup_batch_pallas"): _MIXUP_BATCH,
    ("core/seed_prep.py", "mixup_pallas"): (_WRAPPERS["mixup_pallas"],
                                            _PALLAS),
    ("core/protocols.py", "make_grid_local_train"): _GRID_TRAIN,
    ("sweep/engine.py", "make_grid_local_train"): _GRID_TRAIN,
    ("models/transformer.py", "REMAT_POLICY"): (
        "repro_torch.models.layers:checkpointed",
        "a jax.checkpoint policy: forward(remat=) recomputes through "
        "checkpointed"),
    ("models/transformer.py", "attn_mod"): (
        "repro_torch.models.attention",
        "a module alias: the port imports attention's functions by name"),
    ("models/transformer.py", "grad_dtype_guard"): (
        "repro_torch.models.layers:grad_dtype_guard",
        "a jax custom_vjp cast: autograd keeps the cotangent's dtype"),
    ("models/transformer.py", "set_moe_constraint"): _MOE_HOOK,
    ("launch/dryrun.py", "set_moe_constraint"): _MOE_HOOK,
    ("launch/mesh.py", "ICI_BW"): _ICI,
    ("launch/dryrun.py", "ICI_BW"): _ICI,
}


def _bound_names(stmts):
    """Names a block of module-level statements binds: defs, classes,
    assignments to names, and names imported from the package itself
    (relative or ``repro.``) — its re-exports."""
    for node in stmts:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            yield node.name
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                yield from (e.id for e in elts if isinstance(e, ast.Name))
        elif isinstance(node, ast.ImportFrom):
            if node.level > 0 or (node.module or "").split(".")[0] == "repro":
                yield from (a.asname or a.name for a in node.names)
        elif isinstance(node, ast.If) and ast.unparse(node.test) in (
                "TYPE_CHECKING", "typing.TYPE_CHECKING"):
            continue   # bound for type checkers only, never at run time
        elif isinstance(node, (ast.If, ast.Try)):
            yield from _bound_names(node.body)
            yield from _bound_names(node.orelse)


def public_names(path: Path) -> list:
    names = _bound_names(ast.parse(path.read_text()).body)
    return sorted({n for n in names if not n.startswith("_")})


def port_module_name(rel: str) -> str:
    parts = rel.removesuffix(".py").split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["repro_torch"] + parts)


def resolve(target: str):
    module, _, attr = target.partition(":")
    mod = importlib.import_module(module)
    return getattr(mod, attr) if attr else mod


REF_MODULES = sorted(str(p.relative_to(REF_ROOT))
                     for p in REF_ROOT.rglob("*.py"))


def test_the_walk_sees_the_reference():
    assert len(REF_MODULES) > 50
    assert {"channel/model.py", "core/protocols.py", "kernels/ref.py",
            "models/transformer.py", "sweep/axes.py", "registry.py",
            "launch/dryrun.py"} <= set(REF_MODULES)
    # a def, a package's re-export and a module's re-export of a name
    # imported from elsewhere in the package are public names
    assert "simulate_link" in public_names(REF_ROOT / "channel/model.py")
    assert "device_batches" in public_names(REF_ROOT / "data/__init__.py")
    assert "PROTOCOLS" in public_names(REF_ROOT / "sweep/axes.py")
    # an attribute assignment binds no name (dryrun's os.environ[...])
    assert "os" not in public_names(REF_ROOT / "launch/dryrun.py")
    # nor does an import under TYPE_CHECKING
    assert "FederatedConfig" not in public_names(REF_ROOT /
                                                 "core/seed_prep.py")


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_a_port_counterpart(rel):
    names = public_names(REF_ROOT / rel)
    try:
        port = importlib.import_module(port_module_name(rel))
    except ModuleNotFoundError:
        port = None
    missing = []
    for name in names:
        if (rel, name) in COUNTERPARTS:
            target, why = COUNTERPARTS[(rel, name)]
            assert why and resolve(target) is not None, (rel, name, target)
        elif port is None or not hasattr(port, name):
            missing.append(name)
    assert not missing, (
        f"{rel}: {missing} have no counterpart in "
        f"{port_module_name(rel)}")


def test_counterparts_name_live_reference_names():
    """No stale entry: each key is a public name of its reference module,
    and a name the port module has under the same name needs none."""
    for (rel, name), (target, _) in COUNTERPARTS.items():
        assert name in public_names(REF_ROOT / rel), (rel, name)
        try:
            port = importlib.import_module(port_module_name(rel))
        except ModuleNotFoundError:
            continue
        assert not hasattr(port, name), (rel, name, "is in the port")


def test_same_dataclass_fields_for_the_channel_config():
    """The new host-side draws read ChannelConfig's fields: the port's
    are the reference's."""
    ref = load_reference().channel.ChannelConfig
    assert [f.name for f in dataclasses.fields(ChannelConfig)] == \
        [f.name for f in dataclasses.fields(ref)]
