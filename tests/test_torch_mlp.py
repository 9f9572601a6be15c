"""The port's MLP classifier and model registry against the reference:
logits stacked and unstacked with the reference's weights carried by
``from_jax_params``, the init, and ``build_model``/``parse_model``."""
import jax
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.models import CNN, MLPClassifier, build_model, parse_model
from repro_torch.models.mlp import from_jax_params, to_jax_params
from test_torch_reference import load_reference

SHAPES = [(28, 28, 1), (32, 32, 3), (32, 40, 1)]


def _ref_mlp(shape, classes, seed=3):
    ref = load_reference()
    m = ref.mlp.MLPClassifier(classes, shape)
    return m, jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("shape,classes", zip(SHAPES, (10, 10, 12)))
def test_mlp_logits_match_reference(shape, classes):
    m, pj = _ref_mlp(shape, classes)
    x = np.random.default_rng(0).uniform(0, 1, (16,) + shape).astype(
        np.float32)
    want = np.asarray(m.apply(pj, x))
    got = MLPClassifier(classes, shape).apply(from_jax_params(pj),
                                              torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_mlp_stacked_apply_matches_reference_vmap():
    """Device-stacked weights and batches: one bmm a layer against the
    reference's vmap over devices."""
    ref = load_reference()
    m = ref.mlp.MLPClassifier(10, (28, 28, 1))
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    pj = jax.tree.map(np.asarray, jax.vmap(m.init)(keys))
    x = np.random.default_rng(1).uniform(0, 1, (3, 7, 28, 28, 1)).astype(
        np.float32)
    want = np.asarray(jax.vmap(m.apply)(pj, x))
    got = MLPClassifier(10, (28, 28, 1)).apply_stacked(
        from_jax_params(pj), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_mlp_init_and_converter_match_reference(shape):
    m, pj = _ref_mlp(shape, 10, seed=7)
    pt = to_jax_params(MLPClassifier(10, shape).init(rng.PRNGKey(7)))
    assert sorted(pt) == sorted(pj) == ["layer0", "layer1", "layer2"]
    for name in pj:
        for leaf in pj[name]:
            # jax.random.normal through erfinv: a few float32 ulps
            np.testing.assert_allclose(pt[name][leaf], pj[name][leaf],
                                       rtol=1e-6, atol=1e-7)
    back = to_jax_params(from_jax_params(pj))
    for name in pj:
        for leaf in pj[name]:
            np.testing.assert_array_equal(back[name][leaf], pj[name][leaf])
    assert MLPClassifier.num_params(from_jax_params(pj)) == \
        m.num_params(pj)


def test_mlp_refuses_another_input_shape():
    with pytest.raises(ValueError, match="built for input shape"):
        MLPClassifier(10, (28, 28, 1)).apply_stacked(
            MLPClassifier(10, (28, 28, 1)).init(rng.PRNGKey(0)),
            torch.zeros(1, 2, 32, 32, 3))


@pytest.mark.parametrize("spec", ["cnn", "mlp", "conv", "paper_cnn",
                                  "cnn+mlp", "mlp+cnn", "cnn+cnn",
                                  "mlp+mlp+cnn", "cnn+tf"])
def test_parse_model_matches_reference(spec):
    ref = load_reference().model_registry
    want, got = ref.parse_model(spec), parse_model(spec)
    assert (got.parts, got.name, got.mixed) == (want.parts, want.name,
                                                want.mixed)
    for d in (1, 4, 7, 10):
        assert got.partition(d) == want.partition(d)


@pytest.mark.parametrize("name,shape,classes", [
    ("cnn", (28, 28, 1), 10), ("cnn", (32, 32, 3), 10),
    ("cnn", (32, 40, 1), 12), ("mlp", (28, 28, 1), 10),
    ("conv", (32, 40, 1), 12), ("mlp", (32, 32, 3), 10)])
def test_build_model_matches_reference(name, shape, classes):
    ref = load_reference().model_registry
    want = ref.build_model(name, shape, classes)
    got = build_model(name, shape, classes)
    assert type(got).__name__ == type(want).__name__
    assert (got.input_shape, got.num_classes) == (want.input_shape,
                                                  want.num_classes)
    pj = want.init(jax.random.PRNGKey(0))
    pt = got.init(rng.PRNGKey(0))
    assert got.num_params(pt) == want.num_params(pj)
    if isinstance(got, CNN):
        assert got.fc_in == want.fc_in


def test_model_registry_errors():
    ref = load_reference().model_registry
    with pytest.raises(ValueError) as want:
        ref.parse_model("cnn+rnn")
    with pytest.raises(ValueError) as got:
        parse_model("cnn+rnn")
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        build_model("transformer", (28, 28, 1), 10)
