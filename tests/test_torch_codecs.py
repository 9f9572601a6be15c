"""The port's link codecs and DP ledger against the reference: each
codec's encode and decode on soft-label tables and on CNN and MLP
parameters within 1e-6 (the draws follow the reference's per-device
keys and per-leaf ``fold_in`` in ``jax.tree.flatten`` order, conv
weights drawn HWIO), payload bits equal, and the accountant within
rtol 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.channel import ChannelConfig
from repro_torch.channel import payload
from repro_torch.channel.pipeline import LinkPlan, uplink_stage
from repro_torch.core import privacy
from repro_torch.models import cnn as port_cnn
from repro_torch.models import mlp as port_mlp
from test_torch_reference import load_reference

CODECS = ["identity", "quantize8", "quantize4", "quantize1", "delta",
          "dp_gaussian1.0", "dp_gaussian0.5"]
KEY = 11


def _tables(D=4, C=10, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.dirichlet(np.ones(C), size=(D, C)).astype(np.float32),
            rs.dirichlet(np.ones(C), size=(D, C)).astype(np.float32))


def _key():
    return (jax.random.PRNGKey(KEY),
            torch.tensor(np.asarray(jax.random.PRNGKey(KEY)),
                         dtype=torch.int64))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("protocol", ["fd", "mix2fld"])
def test_table_codec_matches_reference(codec, protocol):
    ref = load_reference()
    favg, dg = _tables()
    kj, kt = _key()
    _, want = ref.pipeline.uplink_stage(
        ref.payload.parse_codec(codec), protocol, None, jnp.asarray(favg),
        kj, jnp.asarray(dg), None)
    _, got = uplink_stage(payload.parse_codec(codec), protocol, None,
                          torch.tensor(favg), kt, torch.tensor(dg), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _stacked(tree, D):
    return jax.tree.map(
        lambda p: jnp.stack([p * (1.0 + 0.1 * d) + 0.01 * d
                             for d in range(D)]), tree)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("arch", ["cnn", "mlp"])
def test_param_codec_matches_reference(codec, arch):
    ref = load_reference()
    if arch == "cnn":
        m, conv = ref.cnn.CNN(), port_cnn
    else:
        m, conv = ref.mlp.MLPClassifier(10, (28, 28, 1)), port_mlp
    g = m.init(jax.random.PRNGKey(1))
    devp = _stacked(g, 3)
    kj, kt = _key()
    want, _ = ref.pipeline.uplink_stage(ref.payload.parse_codec(codec), "fl",
                                        devp, None, kj, None, g)
    got, _ = uplink_stage(payload.parse_codec(codec), "fl",
                          conv.from_jax_params(jax.tree.map(np.asarray,
                                                            devp)),
                          None, kt, None,
                          conv.from_jax_params(jax.tree.map(np.asarray, g)))
    got = conv.to_jax_params(got)
    for k in want:
        for n in want[k]:
            np.testing.assert_allclose(got[k][n], np.asarray(want[k][n]),
                                       rtol=0, atol=1e-6, err_msg=(k, n))


@pytest.mark.parametrize("x,levels", [(0.3, 255.0), (0.999, 15.0),
                                      (0.0, 1.0)])
def test_stochastic_round_and_quantize_affine_match_reference(x, levels):
    ref = load_reference().payload
    rs = np.random.default_rng(3)
    a = (x + 0.1 * rs.standard_normal((3, 5, 7))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    kt = torch.tensor(np.asarray(keys), dtype=torch.int64)
    u = rng.uniform(kt, (5, 7))
    want = jax.vmap(lambda v, k: ref.stochastic_round(
        jnp.clip(v, 0, 1), k, levels))(a, keys)
    got = payload.stochastic_round(torch.tensor(a).clamp(0, 1), u, levels)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax.vmap(lambda v, k: ref.quantize_affine(v, k, levels))(a, keys)
    got = payload.quantize_affine(torch.tensor(a), u, levels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("codec", CODECS + ["quantize16"])
@pytest.mark.parametrize("protocol", ["fl", "fd", "fld", "mixfld",
                                      "mix2fld"])
def test_payload_bits_and_link_plan_match_reference(codec, protocol):
    ref = load_reference()
    kw = dict(n_mod=12490, n_labels=10, sample_bits=6272, n_seed=10)
    want = ref.payload.round_payload_bits(protocol, codec=codec, **kw)
    got = payload.round_payload_bits(protocol, codec=codec, **kw)
    assert tuple(got) == tuple(want)
    ch_r = ref.channel.ChannelConfig(num_devices=10, p_up_dbm=23.0)
    want = ref.pipeline.LinkPlan.build(protocol, ch_r, codec=codec,
                                       n_links=5, **kw)
    got = LinkPlan.build(protocol, ChannelConfig(num_devices=10,
                                                 p_up_dbm=23.0),
                         codec=codec, n_links=5, **kw)
    for f in ("p_up", "p_dn", "up_slots_first", "up_slots", "dn_slots",
              "up_bits_first", "up_bits", "dn_bits", "n_links"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("spec", ["identity", "quantize", "quantize8",
                                  "quantize33", "quantize0", "delta",
                                  "delta3", "dp_gaussian", "dp_gaussian0.5",
                                  "dp_gaussian0", "zip", "quantize8x"])
def test_parse_codec_and_link_config_match_reference(spec):
    ref = load_reference().payload
    results = []
    for mod in (ref, payload):
        try:
            s = mod.parse_codec(spec, dp_clip=2.0)
            link = mod.LinkConfig(codec=spec, dp_delta=1e-6).spec()
            results.append((s.name, s.quant_bits, s.dp_sigma, s.dp_clip,
                            s.dp_delta, s.levels, s.element_bits(32),
                            link.dp_delta))
        except ValueError as e:
            results.append(str(e))
    assert results[1] == results[0]


def test_gaussian_accountant_matches_reference():
    ref = load_reference().privacy
    for sigma, delta in ((1.0, 1e-5), (0.5, 1e-3), (3.0, 0.1)):
        a, b = (m.GaussianAccountant(sigma, delta, sample_ratio=0.5)
                for m in (ref, privacy))
        assert b.ledger() == a.ledger()
        for cohort in (None, [0, 3], [1, 3, 7], np.array([3]), None):
            a.step(cohort=cohort)
            b.step(cohort=cohort)
            np.testing.assert_allclose(b.epsilon(), a.epsilon(), rtol=1e-12)
            la, lb = a.ledger(), b.ledger()
            assert set(la) == set(lb)
            for k in la:
                if isinstance(la[k], float):
                    np.testing.assert_allclose(lb[k], la[k], rtol=1e-12)
                else:
                    assert lb[k] == la[k], k
        np.testing.assert_array_equal(b.device_counts, a.device_counts)
        a.step(n=3)
        b.step(n=3)
        np.testing.assert_allclose(b.epsilon_device_max(),
                                   a.epsilon_device_max(), rtol=1e-12)
        np.testing.assert_allclose(
            privacy.gaussian_epsilon(sigma, delta, 7),
            ref.gaussian_epsilon(sigma, delta, 7), rtol=1e-12)
    for bad in ((0.0, 1e-5), (1.0, 0.0), (1.0, 1.0)):
        with pytest.raises(ValueError) as want:
            ref.GaussianAccountant(*bad)
        with pytest.raises(ValueError) as got:
            privacy.GaussianAccountant(*bad)
        assert str(got.value) == str(want.value)


def test_privacy_metrics_and_mechanism_match_reference():
    ref = load_reference().privacy
    rs = np.random.default_rng(4)
    up = rs.standard_normal((6, 5, 5, 1)).astype(np.float32)
    raws = rs.standard_normal((6, 2, 5, 5, 1)).astype(np.float32)
    np.testing.assert_allclose(
        privacy.sample_privacy(torch.tensor(up), torch.tensor(raws)).numpy(),
        np.asarray(ref.sample_privacy(up, raws)), rtol=1e-6)
    np.testing.assert_allclose(
        privacy.mean_privacy(torch.tensor(up), torch.tensor(raws)),
        ref.mean_privacy(up, raws), rtol=1e-6)
    for scale in (0.01, 10.0):     # under and over the clip
        x = (scale * up[0]).astype(np.float32)
        np.testing.assert_allclose(
            privacy.clip_by_norm(torch.tensor(x), 1.5).numpy(),
            np.asarray(ref.clip_by_norm(x, 1.5)), rtol=0, atol=1e-6)
        kj, kt = _key()
        np.testing.assert_allclose(
            privacy.gaussian_mechanism(torch.tensor(x), kt, 0.7 * 1.5,
                                       1.5).numpy(),
            np.asarray(ref.gaussian_mechanism(x, kj, 0.7, 1.5)), rtol=0,
            atol=1e-6)
