"""The port's round-loop modules against the reference, one at a time:
local SGD, seed collection, the link plan, losses, eq. 2 and eq. 5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.channel import ChannelConfig, LinkPlan
from repro_torch.core import conversion, losses, mixup, outputs
from repro_torch.core.protocols import (FederatedConfig, gout_update,
                                        make_local_train, weighted_avg)
from repro_torch.core.seed_prep import collect_seeds, summarize_seeds
from repro_torch.kernels.distill_loss import distill_phi_psi
from repro_torch.models import CNN, from_jax_params, to_jax_params
from test_torch_reference import (GOLDEN_CFG, GOLDEN_P_UP_DBM, golden_data,
                                  load_reference)

# a few float32 ulps per step, accumulated over the steps of a round
ATOL = 1e-5


def _stack(params, d):
    return jax.tree.map(lambda p: np.broadcast_to(p, (d,) + p.shape).copy(),
                        params)


def _golden_round_inputs(p_round):
    """The golden run's init and device keys for round ``p_round``; G_out
    uniform in round 1 (as initialised), random rows afterwards."""
    kinit, key = jax.random.split(jax.random.PRNGKey(0))
    keys = jax.random.split(jax.random.fold_in(
        jax.random.fold_in(key, p_round), 1), 4)
    g = (np.full((4, 10, 10), 0.1, np.float32) if p_round == 1 else
         np.random.default_rng(p_round).dirichlet(
             np.ones(10), (4, 10)).astype(np.float32))
    return kinit, keys, g


@pytest.mark.parametrize("use_kd", [False, True])
@pytest.mark.parametrize("p_round", [1, 2, 3])
def test_local_train_one_round_matches_reference(p_round, use_kd):
    ref = load_reference()
    dev_x, dev_y, _, _ = golden_data()
    D, C, K, B = 4, 10, 8, 16
    kinit, keys, g = _golden_round_inputs(p_round)
    pj = _stack(jax.tree.map(np.asarray, ref.cnn.CNN().init(kinit)), D)
    base = ref.protocols.make_local_train(ref.cnn.CNN().apply, C, K, B)
    want = jax.vmap(lambda p, x, y, k, gg: base(
        p, x, y, k, gg, use_kd, 0.01, 0.01, x.shape[0]))(
            pj, jnp.asarray(dev_x), jnp.asarray(dev_y), keys,
            jnp.asarray(g))
    lt = make_local_train(CNN().apply_stacked, C, K, B)
    got = lt(from_jax_params(pj), torch.tensor(dev_x),
             torch.tensor(dev_y).long(), torch.tensor(np.asarray(keys)),
             torch.tensor(g), use_kd, 0.01, 0.01, dev_x.shape[1])
    pt = to_jax_params(got[0])
    for name in pt:
        for leaf in pt[name]:
            np.testing.assert_allclose(pt[name][leaf],
                                       np.asarray(want[0][name][leaf]),
                                       rtol=0, atol=ATOL)
    for w, t in zip(want[1:], got[1:]):   # favg, cnt, mean loss
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


def _pool_gaps(h, side):
    """Per device: the smallest gap between the two largest values of a
    2x2 max-pool window whose maximum is positive."""
    d, b, _, _, c = h.shape
    w = h.reshape(d, b, side, 2, side, 2, c).transpose(
        0, 1, 2, 4, 6, 3, 5).reshape(d, -1, 4)
    top = np.sort(w, -1)
    gap = np.where(top[..., -1] > 0, top[..., -1] - top[..., -2], np.inf)
    return gap.min(-1)


def test_local_sgd_gradients_differ_only_at_maxpool_near_ties():
    """Teacher-forced local SGD: from the reference's parameters at every
    step, the port's per-device gradients agree with the reference's to
    1e-5, except on a device whose batch holds a max-pool window with two
    values closer than the convolutions' rounding difference.  There the
    two implementations may pick different maxima and route that
    window's gradient elsewhere (this draw hits one such window)."""
    ref = load_reference()
    dev_x, dev_y, _, _ = golden_data()
    D, C, B = 4, 10, 16
    m = ref.cnn.CNN()
    p = _stack(jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0))), D)
    g = np.random.default_rng(0).dirichlet(np.ones(C), (D, C)).astype(
        np.float32)
    keys = torch.tensor(np.asarray(jax.random.split(
        jax.random.PRNGKey(5), D)))
    idx = rng.randint(rng.split(keys, 8), (B,), 0, 300).numpy()

    def loss_j(pp, xb, yb, gg):
        return ref.losses.fd_loss(m.apply(pp, xb), yb, gg, 0.01)[0]

    def acts_j(pp, xb):
        h1 = jax.nn.relu(m._conv(xb, pp["conv1"]))
        h2 = jax.nn.relu(m._conv(m._pool(h1), pp["conv2"]))
        return h1, h2

    grad_j = jax.jit(jax.vmap(jax.grad(loss_j)))
    dev = torch.arange(D)[:, None]
    for k in range(8):
        xb = np.stack([dev_x[d][idx[d, k]] for d in range(D)])
        yb = np.stack([dev_y[d][idx[d, k]] for d in range(D)])
        gj = jax.tree.map(np.asarray, grad_j(p, xb, yb, g))
        h1, h2 = (np.asarray(a) for a in jax.vmap(acts_j)(p, xb))
        gap = np.minimum(_pool_gaps(h1, 14), _pool_gaps(h2, 7))
        tp = from_jax_params(p)
        leaves = [t.requires_grad_(True) for v in tp.values()
                  for t in v.values()]
        logits = CNN().apply_stacked(tp, torch.tensor(xb))
        yt = torch.tensor(yb).long()
        phi, psi = distill_phi_psi(logits.reshape(-1, C), yt.reshape(-1),
                                   torch.tensor(g)[dev, yt].reshape(-1, C))
        loss = phi.view(D, B).mean(1) + 0.01 * psi.view(D, B).mean(1)
        gt = torch.autograd.grad(loss.sum(), leaves)
        names = [(n, l) for n in tp for l in tp[n]]
        gt = to_jax_params(_unflat(tp, [t.detach() for t in gt]))
        for d in range(D):
            diff = max(float(np.abs(gt[n][l][d] - gj[n][l][d]).max())
                       for n, l in names)
            assert diff <= ATOL or gap[d] <= ATOL, (k, d, diff, gap[d])
        p = jax.tree.map(lambda a, b: a - 0.01 * b, p, gj)


def _unflat(like, leaves):
    it = iter(leaves)
    return {k: {n: next(it) for n in v} for k, v in like.items()}


@pytest.mark.parametrize("protocol", ["fld", "mixfld", "mix2fld"])
def test_collect_seeds_matches_reference(protocol):
    ref = load_reference()
    dev_x, dev_y, _, _ = golden_data()
    kw = dict(GOLDEN_CFG, protocol=protocol)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 2)
    want = ref.protocols.collect_seeds(ref.protocols.FederatedConfig(**kw),
                                       dev_x, dev_y, key)
    got = collect_seeds(FederatedConfig(**kw), torch.tensor(dev_x),
                        torch.tensor(dev_y).long(),
                        torch.tensor(np.asarray(key), dtype=torch.int64))
    assert summarize_seeds(got) == ref.seed_prep.summarize_seeds(want)
    np.testing.assert_array_equal(got["train_y"].numpy(),
                                  np.asarray(want["train_y"]))
    for k in ("train_x", "uploaded"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)


def test_collect_seeds_single_class_degrades_to_soft_labels():
    """The reference's own test of this fallback cannot run (ROADMAP C2):
    a population holding one class cannot pair or cycle, so mix2fld
    trains on the soft-labelled uploads instead of crashing."""
    x = torch.rand(4, 40, 28, 28, 1)
    y = torch.full((4, 40), 2)
    fc = FederatedConfig(protocol="mix2fld", num_devices=4, n_seed=6,
                         n_inverse=12)
    seeds = collect_seeds(fc, x, y, rng.PRNGKey(0))
    assert seeds["train_y"].dim() == 2
    assert torch.isfinite(seeds["train_x"]).all()


def test_pairing_and_cycle_search_match_reference():
    ref = load_reference()
    rs = np.random.default_rng(4)
    for n, c in ((60, 10), (400, 10), (300, 4)):
        minor = rs.integers(0, c, n)
        major = (minor + rs.integers(1, c, n)) % c
        dev = np.repeat(np.arange(n // 10), 10)
        np.testing.assert_array_equal(
            mixup.pair_symmetric(minor, major, dev),
            ref.mixup.pair_symmetric(minor, major, dev))
        for length in (3, 4, 5):
            np.testing.assert_array_equal(
                mixup.find_label_cycles(minor, major, dev, length),
                ref.mixup.find_label_cycles(minor, major, dev, length))


def test_inverse_mixup_cycles_match_reference():
    ref = load_reference()
    rs = np.random.default_rng(2)
    mixed = rs.uniform(0, 1, (30, 49)).astype(np.float32)
    cycles = rs.permutation(30)[:24].reshape(6, 4)
    np.testing.assert_allclose(
        mixup.inverse_mixup_cycles(torch.tensor(mixed), cycles, 0.1).numpy(),
        np.asarray(ref.mixup.inverse_mixup_cycles(mixed, cycles, 0.1)),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("protocol", ["fl", "fd", "mix2fld"])
@pytest.mark.parametrize("first_round", [True, False])
def test_link_plan_draw_matches_reference(protocol, first_round):
    ref = load_reference()
    kw = dict(n_mod=12490, n_labels=10, sample_bits=6272, n_seed=10)
    for p_up in (23.0, GOLDEN_P_UP_DBM, 10.0):
        ch_j = ref.channel.ChannelConfig(num_devices=10, p_up_dbm=p_up)
        ch_t = ChannelConfig(num_devices=10, p_up_dbm=p_up)
        plan_j = ref.pipeline.LinkPlan.build(protocol, ch_j, **kw)
        plan_t = LinkPlan.build(protocol, ch_t, **kw)
        assert plan_t.up_slots_first == plan_j.up_slots_first
        assert plan_t.dn_slots == plan_j.dn_slots
        for seed in range(4):
            kj = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
            want = plan_j.draw(kj, first_round)
            got = plan_t.draw(torch.tensor(np.asarray(kj),
                                           dtype=torch.int64), first_round)
            np.testing.assert_array_equal(got["up_ok"], want["up_ok"])
            np.testing.assert_array_equal(got["dn_ok"], want["dn_ok"])
            np.testing.assert_array_equal(got["t_up"].numpy(),
                                          np.asarray(want["t_up"]))
            assert got["latency_s"] == want["latency_s"]


def test_losses_outputs_and_aggregation_match_reference():
    ref = load_reference()
    rs = np.random.default_rng(8)
    z = rs.standard_normal((64, 10)).astype(np.float32)
    y = rs.integers(0, 10, 64)
    gout = rs.dirichlet(np.ones(10), 10).astype(np.float32)
    soft = rs.dirichlet(np.ones(10), 64).astype(np.float32)
    zt, yt, gt = torch.tensor(z), torch.tensor(y), torch.tensor(gout)
    for use_kernel in (None, False):
        want = ref.losses.fd_loss(jnp.asarray(z), jnp.asarray(y, jnp.int32),
                                  jnp.asarray(gout), 0.01,
                                  use_kernel=use_kernel)[0]
        got = losses.fd_loss(zt, yt, gt, 0.01, use_kernel=use_kernel)[0]
        np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    np.testing.assert_allclose(
        float(losses.cross_entropy(zt, torch.tensor(soft))),
        float(ref.losses.cross_entropy(jnp.asarray(z), jnp.asarray(soft))),
        atol=1e-6)
    probs = rs.dirichlet(np.ones(10), 64).astype(np.float32)
    for w, t in zip(ref.outputs.label_averaged_outputs(probs, y, 10),
                    outputs.label_averaged_outputs(torch.tensor(probs), yt,
                                                   10)):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-6)
    favg = rs.dirichlet(np.ones(10), (4, 10)).astype(np.float32)
    cnt = rs.integers(0, 5, (4, 10)).astype(np.float32)
    ok = np.array([1, 0, 1, 1], np.float32)
    np.testing.assert_allclose(
        gout_update(torch.tensor(favg), torch.tensor(cnt),
                    torch.tensor(ok)).numpy(),
        np.asarray(ref.protocols.gout_update(favg, cnt, ok)), atol=1e-6)
    stacked = {"fc": {"w": rs.standard_normal((4, 3, 2)).astype(np.float32),
                      "b": rs.standard_normal((4, 2)).astype(np.float32)}}
    want = ref.protocols.weighted_avg(stacked, ok * 300)
    got = weighted_avg({"fc": {k: torch.tensor(v) for k, v in
                               stacked["fc"].items()}},
                       torch.tensor(ok * 300))
    for k in ("w", "b"):
        np.testing.assert_allclose(got["fc"][k].numpy(),
                                   np.asarray(want["fc"][k]), atol=1e-6)


@pytest.mark.parametrize("hard", [True, False])
def test_output_to_model_matches_reference(hard):
    ref = load_reference()
    rs = np.random.default_rng(1)
    pj = jax.tree.map(np.asarray, ref.cnn.CNN().init(jax.random.PRNGKey(2)))
    sx = rs.uniform(0, 1, (48, 28, 28, 1)).astype(np.float32)
    sy = (rs.integers(0, 10, 48) if hard else
          rs.dirichlet(np.ones(10), 48).astype(np.float32))
    gout = rs.dirichlet(np.ones(10), 10).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want, wl = ref.conversion.output_to_model(
        ref.cnn.CNN().apply, pj, sx, sy, gout, 8, 16, 0.01, 0.01, key)
    got, gl = conversion.output_to_model(
        CNN().apply, from_jax_params(pj), torch.tensor(sx),
        torch.tensor(sy), torch.tensor(gout), 8, 16, 0.01, 0.01,
        torch.tensor(np.asarray(key), dtype=torch.int64))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=ATOL)
    pt = to_jax_params(got)
    for name in pt:
        for leaf in pt[name]:
            np.testing.assert_allclose(pt[name][leaf],
                                       np.asarray(want[name][leaf]),
                                       rtol=0, atol=ATOL)
