"""The port's optimizers (``repro_torch.optim``) against the reference's
``repro.optim``, on the CPU.

The port's cover for ``tests/test_system.py:39`` (every optimizer drives
a quadratic down), ``:54`` (clipping by the global norm) and ``:78``
(the cosine schedule), which cannot run under the installed jax
(ROADMAP C1): each asserts what that test asserts, and the optimizers
are also held to the live reference over 10 updates within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import optim
from test_torch_reference import load_reference


def _loss(p):
    return ((p["w"] - 3.0) ** 2).sum()


def _grad(p):
    w = p["w"].detach().requires_grad_(True)
    (g,) = torch.autograd.grad(_loss({"w": w}), (w,))
    return {"w": g}


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_decrease_quadratic(name):
    """tests/test_system.py:39: 50 steps at lr 0.1 bring the loss below
    5% of its start."""
    opt = optim.get_optimizer(name, 0.1)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    l0 = float(_loss(params))
    for _ in range(50):
        params, state = opt.update(_grad(params), state, params)
    assert float(_loss(params)) < l0 * 0.05, name
    assert int(state["step"]) == 50


def test_clip_by_global_norm():
    """tests/test_system.py:54: a (4,) gradient of 100s clips to norm 1
    (rtol 1e-5) and reports the norm before clipping, 200."""
    g = {"a": torch.ones(4) * 100.0}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    total = torch.sqrt(sum((x ** 2).sum() for x in clipped.values()))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-5)
    assert float(norm) == pytest.approx(200.0)
    # below the bound nothing changes
    small, _ = optim.clip_by_global_norm({"a": torch.ones(4) * 0.1}, 1.0)
    assert torch.equal(small["a"], torch.ones(4) * 0.1)


def test_cosine_schedule_monotone_after_warmup():
    """tests/test_system.py:78, and every value against the reference's
    schedule."""
    lr = optim.cosine_schedule(1.0, warmup=10, total=100)
    vals = [float(lr(s)) for s in range(0, 100, 10)]
    assert vals[0] == 0.0
    assert max(vals) <= 1.0
    assert vals[-1] < vals[2]
    want = load_reference().optim.cosine_schedule(1.0, warmup=10, total=100)
    np.testing.assert_allclose(
        [float(lr(s)) for s in range(0, 120, 3)],
        [float(want(s)) for s in range(0, 120, 3)], rtol=0, atol=1e-7)


def _tree(rng_, shapes):
    return {k: rng_.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("name,lr", [
    ("sgd", 0.05), ("momentum", 0.05), ("adam", 0.01),
    ("adam", "cosine"), ("momentum", "cosine")])
def test_optimizer_matches_reference_over_10_updates(name, lr):
    """The same gradients (drawn from a seed) through the port's and the
    reference's optimizer: parameters and state within 1e-6 after each
    of 10 updates, on a tree of two levels."""
    ref = load_reference().optim
    g = np.random.default_rng(3)
    shapes = {"a": (3, 5), "b": (7,)}
    p0 = {"x": _tree(g, shapes), "y": {"z": g.standard_normal(
        (2, 2)).astype(np.float32)}}
    if lr == "cosine":
        lr_port = optim.cosine_schedule(0.05, warmup=3, total=10)
        lr_ref = ref.cosine_schedule(0.05, warmup=3, total=10)
    else:
        lr_port = lr_ref = lr
    opt, opt_ref = (optim.get_optimizer(name, lr_port),
                    ref.get_optimizer(name, lr_ref))
    pt = jax.tree.map(torch.tensor, p0)
    pj = jax.tree.map(jnp.asarray, p0)
    st, sj = opt.init(pt), opt_ref.init(pj)
    for _ in range(10):
        grads = {"x": _tree(g, shapes),
                 "y": {"z": g.standard_normal((2, 2)).astype(np.float32)}}
        pt, st = opt.update(jax.tree.map(torch.tensor, grads), st, pt)
        pj, sj = opt_ref.update(jax.tree.map(jnp.asarray, grads), sj, pj)
        for a, b in zip(jax.tree.leaves((pt, st)), jax.tree.leaves((pj, sj))):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=0, atol=1e-6)


def test_clip_matches_reference():
    ref = load_reference().optim
    g = np.random.default_rng(4)
    tree = {"a": g.standard_normal((4, 3)).astype(np.float32) * 5,
            "b": {"c": g.standard_normal(6).astype(np.float32)}}
    got, gn = optim.clip_by_global_norm(jax.tree.map(torch.tensor, tree), 2.0)
    want, wn = ref.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 2.0)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_updates_are_out_of_place():
    p = {"w": torch.ones(3)}
    for name in ("sgd", "momentum", "adam"):
        opt = optim.get_optimizer(name, 0.1)
        new, _ = opt.update({"w": torch.ones(3)}, opt.init(p), p)
        assert torch.equal(p["w"], torch.ones(3))
        assert not torch.equal(new["w"], p["w"])
