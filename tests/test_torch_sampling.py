"""The port's client sampling and the plain Mixup helpers of Tables
II/III against the reference: cohorts and participation counts equal,
``make_mixup_batch``, ``inverse_mixup`` and ``inverse_mixup_n`` within
1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import mixup, sampling
from repro_torch.core.protocols import FederatedConfig
from test_torch_reference import load_reference


@pytest.mark.parametrize("ratio,pool,min_active,seed", [
    (0.5, 10, 1, 0), (0.3, 10, 1, 2), (0.1, 100, 1, 0), (1.0, 7, 1, 0),
    (0.05, 10, 3, 1), (0.999, 1000, 1, 5)])
def test_cohorts_and_participation_match_reference(ratio, pool, min_active,
                                                   seed):
    ref = load_reference().sampling
    a = ref.SamplerConfig(ratio, min_active=min_active, seed=seed)
    b = sampling.SamplerConfig(ratio, min_active=min_active, seed=seed)
    assert b.cohort_size(pool) == a.cohort_size(pool)
    for fed_seed in (0, 7):
        for p in range(1, 6):
            np.testing.assert_array_equal(b.cohort(fed_seed, p, pool),
                                          a.cohort(fed_seed, p, pool))
        np.testing.assert_array_equal(
            b.participation_counts(fed_seed, 6, pool),
            a.participation_counts(fed_seed, 6, pool))


@pytest.mark.parametrize("mechanism", ["MECH_SAMPLE", "MECH_CHURN"])
def test_participation_streams_match_reference(mechanism):
    ref = load_reference().sampling
    assert getattr(sampling, mechanism) == getattr(ref, mechanism)
    u_ref, g_ref = ref.participation_uniforms(1, 2, 3, 9,
                                              getattr(ref, mechanism))
    u, g = sampling.participation_uniforms(1, 2, 3, 9,
                                           getattr(sampling, mechanism))
    np.testing.assert_array_equal(u, u_ref)
    np.testing.assert_array_equal(g.random(4), g_ref.random(4))
    np.testing.assert_array_equal(
        sampling.participation_rng(5, 0, 2).random(3),
        ref.participation_rng(5, 0, 2).random(3))


def test_sampler_validation_matches_reference():
    ref = load_reference().sampling
    for cls, kw in (("SamplerConfig", dict(sample_ratio=0.0)),
                    ("SamplerConfig", dict(min_active=0)),
                    ("ChurnConfig", dict(p_active=1.5))):
        with pytest.raises(ValueError) as want:
            getattr(ref, cls)(**kw)
        with pytest.raises(ValueError) as got:
            getattr(sampling, cls)(**kw)
        assert str(got.value) == str(want.value)


# the flat sample_*/codec aliases warn as the reference's do
@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("kw", [
    dict(sample_ratio=0.3, num_devices=10),
    dict(sampler=sampling.SamplerConfig(0.25, seed=4), num_devices=8),
    dict(codec="dp_gaussian0.5", dp_clip=2.0),
    dict(quant_bits=4, codec="quantize"),
    dict(model="cnn+mlp", protocol="fd"),
    dict(model="mlp+cnn+mlp", protocol="fld", num_devices=5),
    dict(model="cnn", model_partition=("mlp", "cnn", "cnn", "mlp"),
         num_devices=4),
    dict(model="mlp", model_partition=("mlp",) * 3, num_devices=3),
    dict(task="speech"), dict(task="cifar10", num_classes=5)])
def test_config_resolution_matches_reference(kw):
    ref = load_reference().protocols
    kw_ref = dict(kw)
    if "sampler" in kw:
        s = kw["sampler"]
        kw_ref["sampler"] = load_reference().sampling.SamplerConfig(
            s.sample_ratio, s.min_active, s.seed)
    want = ref.FederatedConfig(**kw_ref)
    got = FederatedConfig(**kw)
    for f in ("protocol", "model", "task", "num_classes", "sample_bits",
              "model_partition", "sample_ratio", "sample_seed", "codec",
              "quant_bits", "dp_sigma", "dp_clip"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.cohort_size() == want.cohort_size()
    assert got.model_key() == want.model_key()
    assert got.server_model() == want.server_model()
    spec_w, spec_g = want.codec_spec(), got.codec_spec()
    assert (spec_g.name, spec_g.quant_bits, spec_g.dp_sigma) == (
        spec_w.name, spec_w.quant_bits, spec_w.dp_sigma)
    gw, gg = want.arch_groups(), got.arch_groups()
    assert (gw is None) == (gg is None)
    for (aw, iw), (ag, ig) in zip(gw or (), gg or ()):
        assert aw == ag
        np.testing.assert_array_equal(ig, iw)


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("kw", [
    dict(model="cnn+mlp", protocol="fl"),
    dict(model="cnn+mlp", sample_ratio=0.5),
    dict(model_partition=("cnn", "mlp")), dict(model="rnn"),
    dict(codec="zip"), dict(sample_ratio=1.5),
    dict(sampler=sampling.SamplerConfig(0.5), sample_ratio=0.0)])
def test_config_errors_match_reference(kw):
    ref = load_reference().protocols
    kw_ref = dict(kw)
    if "sampler" in kw:
        kw_ref["sampler"] = load_reference().sampling.SamplerConfig(0.5)
    with pytest.raises(ValueError) as want:
        ref.FederatedConfig(**kw_ref)
    with pytest.raises(ValueError) as got:
        FederatedConfig(**kw)
    assert str(got.value) == str(want.value)


def test_make_mixup_batch_matches_reference():
    ref = load_reference().mixup
    rs = np.random.default_rng(5)
    x = rs.uniform(0, 1, (40, 28, 28, 1)).astype(np.float32)
    y = rs.integers(0, 10, 40)
    i, j = rs.integers(0, 40, 12), rs.integers(0, 40, 12)
    want = ref.make_mixup_batch(x, y, i, j, 0.1, 10)
    got = mixup.make_mixup_batch(torch.tensor(x), torch.tensor(y),
                                 torch.tensor(i), torch.tensor(j), 0.1, 10)
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    for w, g in zip(want[2], got[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("lam", [0.1, 0.3, 0.8])
def test_inverse_mixup_matches_reference(lam):
    ref = load_reference().mixup
    rs = np.random.default_rng(6)
    a, b = rs.uniform(0, 1, (2, 16, 784)).astype(np.float32)
    want = ref.inverse_mixup(jnp.asarray(a), jnp.asarray(b), lam)
    got = mixup.inverse_mixup(torch.tensor(a), torch.tensor(b), lam)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("lams", [(0.1, 0.9), (0.1, 0.9, 0.0),
                                  (0.2, 0.5, 0.3), (0.6, 0.1, 0.1, 0.2)])
def test_inverse_mixup_n_matches_reference(lams):
    ref = load_reference().mixup
    n = len(lams)
    rs = np.random.default_rng(n)
    stack = rs.uniform(0, 1, (n, 28, 28, 1)).astype(np.float32)
    want = np.asarray(ref.inverse_mixup_n(jnp.asarray(stack), lams))
    got = mixup.inverse_mixup_n(torch.tensor(stack), lams).numpy()
    assert got.shape == stack.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # mixing the recovered samples again gives the stack back
    mixed = (mixup.circulant(lams) @ torch.tensor(got).reshape(n, -1))
    np.testing.assert_allclose(mixed.reshape(stack.shape).numpy(), stack,
                               atol=1e-4)
