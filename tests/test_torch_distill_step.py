"""The fused local-step distill work (``distill_step``) and the step graph
on the CPU: ``distill_step_plain`` against the reference's local step
(``jax.value_and_grad`` of ``repro.core.losses.fd_loss`` in the logits,
through its Pallas pair in interpret mode, and the eq. (2) sums of
``repro.core.protocols.make_local_train``, vmapped over the devices),
against the autograd pair's backward, and ``StepGraph`` /
``LocalTrain`` / ``OutputToModelSteps`` run eagerly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.core.conversion import (OutputToModelSteps,
                                        output_to_model_steps)
from repro_torch.core.graphs import StepGraph
from repro_torch.core.protocols import make_local_train
from repro_torch.kernels import runtime
from repro_torch.kernels.distill_loss import (distill_step,
                                              distill_step_plain,
                                              phi_psi_bwd_plain)
from repro_torch.models import CNN
from test_torch_reference import load_reference

# float32, another summation order than the reference's
ATOL = 1e-5
SHAPES = [(4, 16, 10), (3, 5, 12)]


def _inputs(D, B, C, seed, zero_rows):
    rs = np.random.default_rng(seed)
    z = (2.0 * rs.standard_normal((D, B, C))).astype(np.float32)
    y = rs.integers(0, C, (D, B))
    g = rs.dirichlet(np.ones(C), (D, C)).astype(np.float32)
    if zero_rows:
        g[:, : C // 2] = 0.0                               # zero rows
        g[:, C // 2:] *= rs.uniform(0.5, 2.0, (D, C - C // 2, 1))
    return z, y, g


def _reference_step(z, y, g, beta, C):
    """The reference's step for one device: (loss, dloss/dz, oh^T softmax,
    sum oh), fd_loss through its Pallas pair (interpret on the CPU)."""
    ref = load_reference()

    def one(z_, y_, g_):
        (l, _), dz = jax.value_and_grad(
            lambda zz: ref.losses.fd_loss(zz, y_, g_, beta), has_aux=True)(z_)
        oh = jax.nn.one_hot(y_, C)
        return l, dz, oh.T @ jax.nn.softmax(z_, axis=-1), jnp.sum(oh, 0)

    return [np.asarray(a) for a in jax.vmap(one)(
        jnp.asarray(z), jnp.asarray(y, jnp.int32), jnp.asarray(g))]


def _buffers(D, C, K, seed):
    rs = np.random.default_rng(seed)
    return (torch.tensor(rs.standard_normal((D, K)).astype(np.float32)),
            torch.tensor(rs.uniform(0, 3, (D, C, C)).astype(np.float32)),
            torch.tensor(rs.integers(0, 4, (D, C)).astype(np.float32)))


@pytest.mark.parametrize("zero_rows", [False, True])
@pytest.mark.parametrize("beta", [0.0, 0.01])
@pytest.mark.parametrize("D,B,C", SHAPES)
def test_distill_step_plain_matches_reference_step(D, B, C, beta,
                                                   zero_rows):
    z, y, g = _inputs(D, B, C, D * B + C, zero_rows)
    loss, dz, osum, cnt = _reference_step(z, y, g, beta, C)
    K, k = 7, 3
    losses, out_sum, count = _buffers(D, C, K, k)
    want_losses = losses.clone().numpy()
    want_losses[:, k] = loss
    want_sum = out_sum.numpy() + osum
    want_cnt = count.numpy() + cnt
    got = distill_step_plain(torch.tensor(z), torch.tensor(y),
                             torch.tensor(g), torch.tensor([beta]),
                             torch.tensor([k]), losses, out_sum, count)
    for w, t in ((dz, got), (want_losses, losses), (want_sum, out_sum),
                 (want_cnt, count)):
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("beta", [0.0, 0.01])
@pytest.mark.parametrize("D,B,C", SHAPES)
def test_distill_step_plain_dz_is_the_pair_backward(D, B, C, beta):
    """dz is the autograd pair's backward at the step's cotangents
    dphi = 1/B and dpsi = beta/B: bit-equal, the same formulas."""
    z, y, g = _inputs(D, B, C, 5, True)
    zt, yt, gt = torch.tensor(z), torch.tensor(y), torch.tensor(g)
    losses, out_sum, cnt = _buffers(D, C, 2, 0)
    got = distill_step_plain(zt, yt, gt, torch.tensor([beta]),
                             torch.tensor([0]), losses, out_sum, cnt)
    rows = gt[torch.arange(D)[:, None], yt].reshape(D * B, C)
    dphi = torch.ones(D * B) / B
    dz, _ = phi_psi_bwd_plain(zt.reshape(D * B, C), yt.reshape(-1), rows,
                              dphi, torch.tensor(beta, dtype=torch.float32)
                              * torch.ones(D * B) / B)
    assert torch.equal(got, dz.view(D, B, C))


@pytest.mark.parametrize("D,B,C", SHAPES)
def test_distill_step_plain_per_device_beta(D, B, C):
    """A beta per device (a sweep group's stacked points) gives each
    device what the one-beta step gives it at that beta, bit for bit;
    a beta of D equal values is the one-beta step."""
    z, y, g = (torch.tensor(a) for a in _inputs(D, B, C, 5, True))
    y = y.long()
    betas = torch.tensor([0.0, 0.01, 0.5, 0.02][:D] + [0.3] * (D - 4))
    k = torch.tensor([1])
    outs = _buffers(D, C, 3, 2)
    got = distill_step_plain(z, y, g, betas, k, *outs)
    for d in range(D):
        one = [t[d:d + 1].clone() for t in _buffers(D, C, 3, 2)]
        want = distill_step_plain(z[d:d + 1], y[d:d + 1], g[d:d + 1],
                                  betas[d:d + 1], k, *one)
        assert torch.equal(got[d], want[0])
        for a, b in zip(outs, one):
            assert torch.equal(a[d], b[0])
    same = [_buffers(D, C, 3, 2) for _ in range(2)]
    assert torch.equal(
        distill_step_plain(z, y, g, torch.full((D,), 0.01), k, *same[0]),
        distill_step_plain(z, y, g, torch.tensor([0.01]), k, *same[1]))
    for a, b in zip(*same):
        assert torch.equal(a, b)


def test_distill_step_takes_the_plain_version_on_the_cpu():
    D, B, C = 3, 5, 12
    z, y, g = (torch.tensor(a) for a in _inputs(D, B, C, 9, False))
    outs = [_buffers(D, C, 4, 1) for _ in range(2)]
    before = runtime.KERNELS["distill_step"].launches
    got = distill_step(z, y, g, torch.tensor([0.01]), torch.tensor([2]),
                       *outs[0])
    want = distill_step_plain(z, y, g, torch.tensor([0.01]),
                              torch.tensor([2]), *outs[1])
    assert runtime.KERNELS["distill_step"].launches == before
    assert torch.equal(got, want)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_step_graph_runs_the_step_eagerly_on_the_cpu():
    calls = {"load": 0, "step": 0}
    k = torch.zeros(1, dtype=torch.int64)

    def load():
        calls["load"] += 1

    def step():
        calls["step"] += 1
        k.add_(1)

    graph = StepGraph(step, k)
    graph.run(load, 5)
    graph.run(load, 3)
    assert calls == {"load": 2, "step": 8} and int(k) == 3
    assert graph.graph is None and graph.replays == 0


def test_add_launches_counts_replays():
    before = runtime.launch_counts()
    runtime.add_launches({"distill_step": 2, "mixup": 1}, times=5)
    after = runtime.launch_counts()
    runtime.add_launches({"distill_step": 2, "mixup": 1}, times=-5)
    assert after["distill_step"] - before["distill_step"] == 10
    assert after["mixup"] - before["mixup"] == 5
    assert runtime.launch_counts() == before


def _population(D, n, seed):
    x, y = (torch.tensor(a) for a in (
        np.random.default_rng(seed).uniform(0, 1, (D, n, 28, 28, 1))
        .astype(np.float32),
        np.random.default_rng(seed + 1).integers(0, 10, (D, n))))
    cnn = CNN()
    p = cnn.init(rng.PRNGKey(seed))
    params = {k: {m: t.expand((D,) + t.shape).clone() for m, t in v.items()}
              for k, v in p.items()}
    return cnn, params, x, y


def test_local_train_results_are_not_its_buffers():
    """A round's returned state is the caller's own: the next round
    (which reuses the static buffers) leaves it as it was, and the input
    parameters are not changed."""
    D, C, K, B = 3, 10, 4, 8
    cnn, params, x, y = _population(D, 40, 0)
    keep = {k: {m: t.clone() for m, t in v.items()} for k, v in
            params.items()}
    lt = make_local_train(cnn.apply_stacked, C, K, B)
    keys = rng.split(rng.PRNGKey(3), D)
    gout = torch.full((D, C, C), 0.1)
    first = lt(params, x, y, keys, gout, True, 0.01, 0.01, 40)
    saved = [{k: {m: t.clone() for m, t in v.items()} for k, v in
              first[0].items()}] + [t.clone() for t in first[1:]]
    second = lt(first[0], x, y, rng.split(rng.PRNGKey(4), D), gout, True,
                0.01, 0.01, 40)
    assert len(lt.graphs) == 1
    for k in params:
        for m in params[k]:
            assert torch.equal(params[k][m], keep[k][m])
            assert torch.equal(first[0][k][m], saved[0][k][m])
            assert not torch.equal(second[0][k][m], first[0][k][m])
    for a, b in zip(first[1:], saved[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hard", [True, False])
def test_output_to_model_keeps_its_graph_and_not_its_results(hard):
    cnn, _, x, y = _population(1, 30, 7)
    p = cnn.init(rng.PRNGKey(1))
    sx = x[0]
    soft = torch.randn(30, 10, generator=torch.Generator().manual_seed(2))
    sy = y[0] if hard else torch.softmax(soft, -1)
    gout = torch.full((10, 10), 0.1)
    conv = OutputToModelSteps(cnn.apply)
    one = {k: {m: t[None] for m, t in v.items()} for k, v in p.items()}
    args = (sx[None], sy[None], gout[None],
            rng.split(rng.PRNGKey(5), 6)[None], torch.tensor([6]), 30, 8,
            torch.tensor([0.01]), torch.tensor([0.01]))
    first, l1 = conv(one, *args)
    saved = {k: {m: t.clone() for m, t in v.items()} for k, v in
             first.items()}
    l1c = l1.clone()
    again, l2 = conv(one, *args)
    assert len(conv.graphs) == 1
    assert torch.equal(l1, l1c) and torch.equal(l2, l1)
    for k in first:
        for m in first[k]:
            assert torch.equal(first[k][m], saved[k][m])
            assert torch.equal(again[k][m], first[k][m])


@pytest.mark.parametrize("hard", [True, False])
def test_output_to_model_steps_is_the_loop_conversion_per_model(hard):
    """The masked conversion of 2 stacked models, each with its own eta,
    beta, seed set (the second padded) and step count (3 of a padded 5):
    each model ends where the loop's conversion of it alone (G = 1, its
    own steps, its seed set unpadded) ends, bit for bit, and the masked
    steps' losses are 0."""
    cnn, _, x, y = _population(2, 30, 11)
    inits = [cnn.init(rng.PRNGKey(s)) for s in (1, 2)]
    params = {k: {m: torch.stack([p[k][m] for p in inits]) for m in v}
              for k, v in inits[0].items()}
    gen = torch.Generator().manual_seed(3)
    soft = torch.softmax(torch.randn(2, 30, 10, generator=gen), -1)
    sy = y if hard else soft
    gout = torch.softmax(torch.randn(2, 10, 10, generator=gen), -1)
    iters, n_train = (5, 3), (30, 24)
    eta, beta = (0.01, 0.05), (0.0, 0.02)
    keys = torch.zeros(2, 5, 2, dtype=torch.int64)
    for g in range(2):
        keys[g, :iters[g]] = rng.split(rng.PRNGKey(7 + g), iters[g])
    got, losses = output_to_model_steps(
        cnn.apply, params, x, sy, gout, keys, torch.tensor(iters),
        torch.tensor(n_train), 8, torch.tensor(eta), torch.tensor(beta))
    for g in range(2):
        n = n_train[g]
        want, lw = output_to_model_steps(
            cnn.apply, {k: {m: t[None] for m, t in v.items()}
                        for k, v in inits[g].items()},
            x[g:g + 1, :n], sy[g:g + 1, :n], gout[g:g + 1],
            keys[g:g + 1, :iters[g]], torch.tensor(iters[g:g + 1]), n, 8,
            torch.tensor(eta[g:g + 1]), torch.tensor(beta[g:g + 1]))
        for k in want:
            for m in want[k]:
                assert torch.equal(got[k][m][g], want[k][m][0])
        assert torch.equal(losses[g, :iters[g]], lw[0])
        assert not losses[g, iters[g]:].any()
