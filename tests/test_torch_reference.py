"""The reference loader for the port's parity tests.

``load_reference()`` imports the JAX package's round loop, CNN, LM
stack (dense and Mamba2), serve driver and kernels for the ``tests/test_torch_*.py``
files.  Under the installed jax
``repro.models.transformer`` cannot be imported: its guard runs
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

import functools
import importlib
import sys
import types

import jax
import numpy as np
import pytest
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
    "channel": "repro.channel",
    "channel_model": "repro.channel.model",
    "pipeline": "repro.channel.pipeline",
    "payload": "repro.channel.payload",
    "registry": "repro.registry",
    "configs": "repro.configs",
    "transformer": "repro.models.transformer",
    "attention": "repro.models.attention",
    "kvcache": "repro.models.kvcache",
    "layers": "repro.models.layers",
    "rope": "repro.models.rope",
    "steps": "repro.launch.steps",
    "serve": "repro.launch.serve",
    "flash_attention": "repro.kernels.flash_attention",
    "ops": "repro.kernels.ops",
    "mamba2": "repro.models.mamba2",
    "ssd_scan": "repro.kernels.ssd_scan",
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


# the reference's golden round-loop config (tests/test_protocols.py)
GOLDEN_CFG = dict(num_devices=4, local_iters=8, local_batch=16,
                  server_iters=8, server_batch=16, max_rounds=3, n_seed=6,
                  n_inverse=12, seed=0)
GOLDEN_P_UP_DBM = 40.0


@functools.lru_cache(maxsize=None)
def golden_data():
    """The golden fixture, made by the reference: synthetic_images
    (PRNGKey(42), 1400), partition_iid over the first 1200 samples."""
    ref = load_reference()
    x, y = ref.data.synthetic_images(jax.random.PRNGKey(42), 1400)
    x, y = np.asarray(x), np.asarray(y)
    dev_x, dev_y = ref.data.partition_iid(x[:1200], y[:1200], 4, 300, 10,
                                          seed=0)
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
