"""The reference loader for the port's parity tests.

``load_reference()`` imports the JAX package's round loop, models and
their registry, data, sampling, codecs and privacy, LM stack (dense,
MoE and Mamba2), serve and train entry points, optimizers, kernels,
round program, checkpoint, service, sweep engine, roofline, meshes and
sharding rules for the
``tests/test_torch_*.py`` files.  Under the installed jax ``repro.models.transformer`` cannot be
imported: its guard runs
``_obar_p not in _batching.primitive_batchers`` and jax 0.9's
``PrimitiveBatchersProxy`` has no ``__contains__`` (ROADMAP C1).  The
loader gives the proxy a ``__contains__`` (membership in
``fancy_primitive_batchers``) for the duration of the import and deletes
it again.  It then drops the ``repro`` modules it imported from
``sys.modules`` (keeping its own references), so that the reference's
own tests, which import ``repro`` themselves, see the same import
behaviour with or without these tests in their process.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import sys
import types

import jax
import numpy as np
import pytest
import torch
from jax._src.interpreters import batching

_MODULES = {
    "protocols": "repro.core.protocols",
    "cnn": "repro.models.cnn",
    "ref": "repro.kernels.ref",
    "distill_loss": "repro.kernels.distill_loss",
    "mixup_kernel": "repro.kernels.mixup_kernel",
    "mixup": "repro.core.mixup",
    "seed_prep": "repro.core.seed_prep",
    "losses": "repro.core.losses",
    "outputs": "repro.core.outputs",
    "conversion": "repro.core.conversion",
    "data": "repro.data",
    "synthetic": "repro.data.synthetic",
    "partition": "repro.data.partition",
    "channel": "repro.channel",
    "channel_model": "repro.channel.model",
    "pipeline": "repro.channel.pipeline",
    "payload": "repro.channel.payload",
    "registry": "repro.registry",
    "model_registry": "repro.models.registry",
    "mlp": "repro.models.mlp",
    "sampling": "repro.core.sampling",
    "privacy": "repro.core.privacy",
    "configs": "repro.configs",
    "transformer": "repro.models.transformer",
    "attention": "repro.models.attention",
    "moe": "repro.models.moe",
    "kvcache": "repro.models.kvcache",
    "layers": "repro.models.layers",
    "rope": "repro.models.rope",
    "steps": "repro.launch.steps",
    "train": "repro.launch.train",
    "optim": "repro.optim",
    "serve": "repro.launch.serve",
    "flash_attention": "repro.kernels.flash_attention",
    "ops": "repro.kernels.ops",
    "mamba2": "repro.models.mamba2",
    "ssd_scan": "repro.kernels.ssd_scan",
    "state": "repro.core.state",
    "program": "repro.core.program",
    "checkpoint": "repro.checkpoint",
    "service": "repro.launch.service",
    "sweep": "repro.sweep",
    "sweep_axes": "repro.sweep.axes",
    "sweep_engine": "repro.sweep.engine",
    "sweep_results": "repro.sweep.results",
    "roofline": "repro.roofline.analysis",
    "mesh": "repro.launch.mesh",
    "sharding": "repro.launch.sharding",
}


def _is_reference(name: str) -> bool:
    return name == "repro" or name.startswith("repro.")


def _load_reference() -> types.SimpleNamespace:
    before = set(sys.modules)
    proxy = type(batching.primitive_batchers)
    proxy.__contains__ = (
        lambda self, prim: prim in batching.fancy_primitive_batchers)
    try:
        mods = {k: importlib.import_module(v) for k, v in _MODULES.items()}
        # the config registry fills lazily: fill it while its package is
        # still in sys.modules, or the registrations land in a new copy
        mods["configs"]._ensure_loaded()
    finally:
        del proxy.__contains__
    for name in sorted(set(sys.modules) - before, reverse=True):
        if not _is_reference(name):
            continue
        mod = sys.modules.pop(name)
        parent, _, leaf = name.rpartition(".")
        if parent in sys.modules and \
                getattr(sys.modules[parent], leaf, None) is mod:
            delattr(sys.modules[parent], leaf)
    return types.SimpleNamespace(**mods)


@functools.lru_cache(maxsize=None)
def load_reference() -> types.SimpleNamespace:
    """The reference modules by short name (see ``_MODULES``), imported
    once per process."""
    return _load_reference()


@contextlib.contextmanager
def one_intra_op_thread():
    """One torch intra-op thread for the block (restored after).  The
    parity runs' CPU ops are small; with several test workers sharing
    the cores, the default thread pool's threads wait for each other far
    longer than the ops take."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(autouse=True, scope="module")
def one_thread_per_module():
    """:func:`one_intra_op_thread` around each module's tests; autouse in
    every parity module that imports it by name."""
    with one_intra_op_thread():
        yield


# the reference's golden round-loop config (tests/test_protocols.py)
GOLDEN_CFG = dict(num_devices=4, local_iters=8, local_batch=16,
                  server_iters=8, server_batch=16, max_rounds=3, n_seed=6,
                  n_inverse=12, seed=0)
GOLDEN_P_UP_DBM = 40.0


@functools.lru_cache(maxsize=None)
def golden_pool(task="digits"):
    """The golden pool, made by the reference: ``task``'s data from
    PRNGKey(42), 1400 samples (synthetic_images for digits)."""
    x, y = load_reference().data.parse_task(task).data(
        jax.random.PRNGKey(42), 1400)
    return np.asarray(x), np.asarray(y)


@functools.lru_cache(maxsize=None)
def golden_data(scheme="iid", task="digits", alpha=1.0):
    """The golden fixture: the reference's ``PartitionSpec(scheme,
    n_local=300)`` over the pool's first 1200 samples for 4 devices (iid:
    partition_iid; noniid: 2·2 + 8·37), the rest as the test set."""
    ref = load_reference()
    x, y = golden_pool(task)
    spec = ref.partition.PartitionSpec(scheme, n_local=300, alpha=alpha)
    dev_x, dev_y = spec.build(x[:1200], y[:1200], 4,
                              ref.data.parse_task(task).num_classes)
    return dev_x, dev_y, x[1200:], y[1200:]


def test_loader_removes_its_patch():
    load_reference()
    proxy = type(batching.primitive_batchers)
    assert "__contains__" not in proxy.__dict__
    with pytest.raises(TypeError):
        object() in batching.primitive_batchers


def test_loader_leaves_no_reference_modules_behind():
    before = sorted(n for n in sys.modules if _is_reference(n))
    ref = _load_reference()
    assert ref.protocols.FederatedTrainer is not None
    assert sorted(n for n in sys.modules if _is_reference(n)) == before
