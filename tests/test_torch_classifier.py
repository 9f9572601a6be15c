"""The port's federated transformer classifier
(``repro_torch.models.transformer.TransformerClassifier``) against the
reference's, on the CPU: the init, the logits (single and
device-stacked), its two-level parameter tree, and ``FederatedTrainer``
runs with ``model="transformer"`` and with a ``cnn+transformer``
cohort, each for 2 rounds at the golden config against the live
reference (loss and accuracy within 1e-4, the link outcomes equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.channel import ChannelConfig
from repro_torch.core.protocols import FederatedConfig, FederatedTrainer
from repro_torch.models import build_model
from repro_torch.models.transformer import (TransformerClassifier,
                                            classifier_from_jax, flatten_tree,
                                            nest_tree, tree_map)
from test_torch_protocols_a import check_history
from test_torch_reference import (GOLDEN_CFG, GOLDEN_P_UP_DBM, golden_data,
                                  load_reference,
                                  one_thread_per_module)  # noqa: F401

ATOL = 1e-4


def classifier_to_jax(params):
    """The port's classifier parameters as numpy arrays in the
    reference's nested tree."""
    return {"patch": tree_map(lambda t: t.numpy(), params["patch"]),
            "tf": nest_tree(tree_map(lambda t: t.numpy(), params["tf"]))}


SHAPES = [((28, 28, 1), 10), ((32, 32, 3), 10), ((32, 40), 12)]


def _ref_model(shape, classes):
    return load_reference().transformer.TransformerClassifier(classes, shape)


@pytest.mark.parametrize("shape,classes", SHAPES)
def test_classifier_logits_match_reference(shape, classes):
    m_ref = _ref_model(shape, classes)
    pj = m_ref.init(jax.random.PRNGKey(3))
    x = np.random.default_rng(0).random((5,) + shape).astype(np.float32)
    want = np.asarray(m_ref.apply(pj, jnp.asarray(x)))
    m = build_model("transformer", shape, classes)
    assert isinstance(m, TransformerClassifier)
    got = m.apply(classifier_from_jax(jax.tree.map(np.asarray, pj)),
                  torch.tensor(x))
    assert got.shape == (5, classes)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)
    assert m.num_params(classifier_from_jax(jax.tree.map(np.asarray, pj))) \
        == m_ref.num_params(pj)


def test_classifier_init_matches_reference():
    m_ref = _ref_model((28, 28, 1), 10)
    pj = jax.tree.map(np.asarray, m_ref.init(jax.random.PRNGKey(7)))
    got = classifier_to_jax(TransformerClassifier(10, (28, 28, 1)).init(
        rng.PRNGKey(7)))
    assert jax.tree.structure(got) == jax.tree.structure(pj)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(pj)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=4e-7)


def test_classifier_tree_is_two_levels_in_reference_leaf_order():
    """The round loop's tree operations take ``{group: {name: leaf}}``;
    the flat "tf" keys sort as the reference's nested leaves do (the
    payload codecs draw their keys in that order)."""
    m = TransformerClassifier(10, (28, 28, 1))
    p = m.init(rng.PRNGKey(0))
    assert set(p) == {"patch", "tf"}
    assert all(torch.is_tensor(t) for v in p.values() for t in v.values())
    flat = [p[k][n] for k in sorted(p) for n in sorted(p[k])]
    nested = jax.tree.leaves(classifier_to_jax(p))
    assert [tuple(t.shape) for t in flat] == [a.shape for a in nested]
    assert nest_tree(flatten_tree({"a": {"b": 1, "c": {"d": 2}}})) == \
        {"a": {"b": 1, "c": {"d": 2}}}


def test_classifier_stacked_matches_vmap():
    """Device-stacked forward (D = 3 devices, their own weights) against
    the reference's vmap of ``apply``."""
    m_ref = _ref_model((28, 28, 1), 10)
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    pj = jax.vmap(m_ref.init)(keys)
    x = np.random.default_rng(2).random((3, 4, 28, 28, 1)).astype(np.float32)
    want = np.asarray(jax.vmap(m_ref.apply)(pj, jnp.asarray(x)))
    got = TransformerClassifier(10, (28, 28, 1)).apply_stacked(
        classifier_from_jax(jax.tree.map(np.asarray, pj)), torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)


def test_classifier_refuses_a_wrong_shape():
    m = TransformerClassifier(10, (28, 28, 1))
    with pytest.raises(ValueError, match="input shape"):
        m.apply(m.init(rng.PRNGKey(0)), torch.zeros(2, 32, 32, 3))


def _run_both(protocol, **kw):
    ref = load_reference()
    cfg = dict(GOLDEN_CFG, max_rounds=2, **kw)
    dev_x, dev_y, tx, ty = golden_data()
    want = ref.protocols.FederatedTrainer(
        None, ref.protocols.FederatedConfig(protocol=protocol, **cfg),
        ref.channel.ChannelConfig(num_devices=4, p_up_dbm=GOLDEN_P_UP_DBM),
    ).run(dev_x, dev_y, tx, ty)
    got = FederatedTrainer(
        None, FederatedConfig(protocol=protocol, **cfg),
        ChannelConfig(num_devices=4, p_up_dbm=GOLDEN_P_UP_DBM),
        device="cpu").run(dev_x, dev_y, tx, ty)
    return want, got


@pytest.mark.parametrize("protocol", ["mix2fld", "fl"])
def test_transformer_run_matches_reference(protocol):
    want, got = _run_both(protocol, model="transformer")
    check_history(want, got)
    assert got["model"] == "transformer" and len(got["loss"]) == 2


def test_cnn_transformer_cohort_matches_reference():
    want, got = _run_both("fd", model="cnn+transformer")
    check_history(want, got)
    assert got["model"] == "cnn+transformer"
