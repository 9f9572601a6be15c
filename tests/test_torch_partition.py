"""The port's partitions, task data and name registries against the
reference: partitions bit-equal (the same host numpy draws), the cifar
and speech data within 1e-6, registries and error texts equal."""
import jax
import numpy as np
import pytest
import torch

from repro_torch import registry, rng
from repro_torch.data import partition as port_partition
from repro_torch.data import (PARTITION_SCHEMES, PartitionSpec,
                              partition_dirichlet, partition_noniid,
                              parse_task, synthetic_audio,
                              synthetic_rgb_images)
from test_torch_reference import load_reference


def _pool(n=1200, classes=10, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((n, 3)).astype(np.float32),
            rs.integers(0, classes, n))


def _equal(want, got):
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("args", [
    dict(num_devices=4), dict(num_devices=10, seed=3),
    # pools run out and are resampled
    dict(num_devices=30, common_count=40, seed=1),
    dict(num_devices=5, rare_labels=3, rare_count=1, common_count=7)])
def test_partition_noniid_is_bit_equal(args):
    ref = load_reference()
    x, y = _pool()
    want = ref.partition.partition_noniid(x, y, **args)
    got = partition_noniid(torch.tensor(x), torch.tensor(y), **args)
    _equal(want, got)
    rare = (got[1][:, :, None] == np.arange(10)).sum(1)
    assert (np.sort(rare, 1)[:, :args.get("rare_labels", 2)]
            == args.get("rare_count", 2)).all()


@pytest.mark.parametrize("alpha,devices,per_device", [
    (0.1, 4, 300), (0.5, 10, 120), (100.0, 6, 200)])
def test_partition_dirichlet_is_bit_equal(alpha, devices, per_device):
    ref = load_reference()
    x, y = _pool()
    want = ref.partition.partition_dirichlet(x, y, devices, per_device, 10,
                                             alpha=alpha, seed=2)
    got = partition_dirichlet(x, y, devices, per_device, 10, alpha=alpha,
                              seed=2)
    _equal(want, got)


@pytest.mark.parametrize("scheme", PARTITION_SCHEMES)
@pytest.mark.parametrize("n_local", [300, 500])
def test_partition_spec_builds_the_reference_partition(scheme, n_local):
    ref = load_reference()
    x, y = _pool(2000)
    want = ref.partition.PartitionSpec(scheme, n_local=n_local, alpha=0.5,
                                       seed=4).build(x, y, 4, 10)
    got = PartitionSpec(scheme, n_local=n_local, alpha=0.5,
                        seed=4).build(torch.tensor(x), torch.tensor(y), 4, 10)
    _equal(want, got)
    assert got[0].shape == (4, n_local, 3)


@pytest.mark.parametrize("kw,build", [
    (dict(scheme="shards"), None), (dict(n_local=0), None),
    (dict(alpha=0.0), None),
    (dict(scheme="noniid", n_local=301), None),
    (dict(scheme="noniid", n_local=5), None),
    (dict(), "2-d")])
def test_partition_spec_errors_match_reference(kw, build):
    ref = load_reference()
    x, y = _pool()
    msgs = []
    for mod in (ref.partition, port_partition):
        with pytest.raises(ValueError) as e:
            spec = mod.PartitionSpec(**kw)
            spec.build(x, y[None] if build else y, 4, 10)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="alpha must be > 0"):
        partition_dirichlet(x, y, 4, 10, 10, alpha=-1.0)
    assert PARTITION_SCHEMES == ref.partition.PARTITION_SCHEMES


@pytest.mark.parametrize("fn,name,kw", [
    (synthetic_rgb_images, "synthetic_rgb_images", {}),
    (synthetic_rgb_images, "synthetic_rgb_images",
     dict(num_classes=4, side=16, channels=2)),
    (synthetic_audio, "synthetic_audio", {}),
    (synthetic_audio, "synthetic_audio", dict(num_classes=5, frames=16,
                                              mels=24))])
def test_task_data_matches_reference(fn, name, kw):
    ref = load_reference()
    xj, yj = getattr(ref.synthetic, name)(jax.random.PRNGKey(5), 300, **kw)
    xt, yt = fn(rng.PRNGKey(5), 300, device="cpu", **kw)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert tuple(xt.shape) == tuple(xj.shape) and xt.dtype == torch.float32
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("task", ["digits", "cifar", "speech", "mnist",
                                  "cifar10", "speech_commands"])
def test_task_specs_match_reference(task):
    ref = load_reference()
    want = ref.data.parse_task(task)
    got = parse_task(task)
    assert (got.name, got.input_shape, got.num_classes,
            got.bits_per_feature, got.sample_bits) == (
        want.name, want.input_shape, want.num_classes,
        want.bits_per_feature, want.sample_bits)
    xj, yj = want.data(jax.random.PRNGKey(1), 20)
    xt, yt = got.data(rng.PRNGKey(1), 20, device="cpu")
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-6)


def test_registries_match_reference():
    ref = load_reference().registry
    for names in ("PROTOCOLS", "PROTOCOL_ALIASES", "FLD_FAMILY", "MODELS",
                  "MODEL_ALIASES", "TASKS", "TASK_ALIASES"):
        assert getattr(registry, names) == getattr(ref, names), names
    for fn, names in (("canonical_protocol", ("fl", "mix2fd", "x")),
                      ("canonical_model", ("cnn", "conv", "tf", "rnn")),
                      ("canonical_task", ("digits", "cifar10", "imagenet"))):
        for name in names:
            try:
                want = getattr(ref, fn)(name)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    getattr(registry, fn)(name)
                assert str(got.value) == str(e)
            else:
                assert getattr(registry, fn)(name) == want
