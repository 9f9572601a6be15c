"""The port's CNN, converter and data against the reference."""
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.data import partition_iid, synthetic_images
from repro_torch.models import CNN, from_jax_params, to_jax_params
from test_torch_reference import load_reference


def _ref_params(seed=3):
    ref = load_reference()
    return jax.tree.map(np.asarray, ref.cnn.CNN().init(
        jax.random.PRNGKey(seed)))


def test_cnn_logits_match_reference():
    ref = load_reference()
    pj = _ref_params()
    x = np.random.default_rng(0).uniform(0, 1, (32, 28, 28, 1)).astype(
        np.float32)
    want = np.asarray(ref.cnn.CNN().apply(pj, x))
    got = CNN().apply(from_jax_params(pj), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_stacked_apply_is_per_device_apply():
    """One grouped-conv pass over D devices == D single-model passes."""
    m = CNN()
    keys = rng.split(rng.PRNGKey(0), 3)
    ps = [m.init(k) for k in keys]
    stacked = {k: {n: torch.stack([p[k][n] for p in ps]) for n in ps[0][k]}
               for k in ps[0]}
    x = torch.rand(3, 5, 28, 28, 1, generator=torch.Generator().manual_seed(1))
    got = m.apply_stacked(stacked, x)
    for d in range(3):
        torch.testing.assert_close(got[d], m.apply(ps[d], x[d]),
                                   rtol=0, atol=1e-5)


def test_converter_round_trip_is_exact():
    pj = _ref_params()
    back = to_jax_params(from_jax_params(pj))
    for name in pj:
        for leaf in pj[name]:
            np.testing.assert_array_equal(back[name][leaf], pj[name][leaf])
    assert from_jax_params(pj)["conv2"]["w"].shape == (20, 14, 3, 3)


def test_cnn_init_matches_reference():
    pj = _ref_params(seed=7)
    pt = to_jax_params(CNN().init(rng.PRNGKey(7)))
    assert CNN.num_params(from_jax_params(pj)) == 12490
    for name in pj:
        for leaf in pj[name]:
            # jax.random.normal through erfinv: a few float32 ulps
            np.testing.assert_allclose(pt[name][leaf], pj[name][leaf],
                                       rtol=1e-6, atol=1e-7)


def test_bilinear_upsample_matches_jax_image_resize():
    coarse = np.random.default_rng(0).standard_normal((10, 7, 7)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(coarse, (10, 28, 28), "bilinear"))
    got = F.interpolate(torch.tensor(coarse)[:, None], size=(28, 28),
                        mode="bilinear", align_corners=False)[:, 0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed,n", [(42, 1400), (0, 300)])
def test_synthetic_images_match_reference(seed, n):
    ref = load_reference()
    xj, yj = ref.synthetic.synthetic_images(jax.random.PRNGKey(seed), n)
    xt, yt = synthetic_images(rng.PRNGKey(seed), n, device="cpu")
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert xt.shape == (n, 28, 28, 1) and xt.dtype == torch.float32
    # normal() through erfinv differs by ulps, then sigmoid
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-6)


def test_partition_iid_matches_reference():
    ref = load_reference()
    rs = np.random.default_rng(0)
    x = rs.standard_normal((700, 4)).astype(np.float32)
    y = rs.integers(0, 10, 700)
    for args in ((4, 60, 10), (10, 100, 10)):  # the second resamples
        want = ref.data.partition_iid(x, y, *args, seed=3)
        got = partition_iid(torch.tensor(x), torch.tensor(y), *args, seed=3)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
