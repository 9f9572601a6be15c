"""The port's threefry PRNG (repro_torch.rng) against jax.random.

Keys and integer draws must be bit-exact; uniform and bernoulli are
pure bit manipulation and exact too.  normal and gumbel go through
erfinv / log, whose last bits differ between XLA's and PyTorch's math
libraries: they are held to 4 float32 ulps, counted at the scale of
max(|value|, 1) because -log(-log(u)) crosses zero, where the relative
spacing of floats vanishes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng


def _k(seed):
    return jax.random.PRNGKey(seed), rng.PRNGKey(seed)


@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1])
def test_keys_split_fold_in_bit_exact(seed):
    kj, kt = _k(seed)
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    for num in (2, 3, 10, 200):
        np.testing.assert_array_equal(np.asarray(jax.random.split(kj, num)),
                                      rng.split(kt, num).numpy())
    for data in (0, 1, 5, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(kj, data)),
            rng.fold_in(kt, data).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.bits(kj, (7, 5))),
                                  rng.random_bits(kt, (7, 5)).numpy())


@pytest.mark.parametrize("shape,lo,hi", [
    ((16,), 0, 300),      # local-SGD batch indices at the golden config
    ((16,), 0, 500),      # ... at the paper's width
    ((10,), 1, 10),       # mixup_pairs class shift
    ((100, 2), -2, 3),    # synthetic-data roll
    ((16,), 0, 48),       # conversion batch over a seed set
    ((4,), 5, 5),         # empty range returns minval
    ((64,), 0, 151936),   # qwen2 vocab: spans above 2**16 wrap in uint32
    ((64,), 3, 70003),
])
def test_randint_bit_exact(shape, lo, hi):
    kj, kt = _k(7)
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(kj, shape, lo, hi)),
        rng.randint(kt, shape, lo, hi).numpy())


def test_batched_keys_match_vmap():
    """A batch of keys draws what jax.vmap over the keys draws (the
    device axis of the local-SGD schedule)."""
    kj, kt = _k(3)
    dj = jax.random.split(kj, 4)
    want = jax.vmap(lambda k: jax.vmap(
        lambda s: jax.random.randint(s, (16,), 0, 300))(
            jax.random.split(k, 8)))(dj)
    got = rng.randint(rng.split(rng.split(kt, 4), 8), (16,), 0, 300)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("bounds", [(300, 60, 100, 1), (5, 5, 0, 7),
                                    (151936, 70003, 48, 2 ** 16 + 1)])
def test_randint_tensor_bound_bit_exact(bounds):
    """Per-row bounds (the sweep grid's n_local and n_train): jax's
    randint with a traced maxval (jit, the bound an argument, vmapped
    over the rows), and the int path's draws at each row's bound."""
    kj, kt = _k(11)
    n = len(bounds)
    draw = jax.jit(jax.vmap(lambda k, m: jax.vmap(
        lambda s: jax.random.randint(s, (16,), 0, m))(
            jax.random.split(k, 8))))
    want = draw(jax.random.split(kj, n), jnp.asarray(bounds, jnp.int32))
    keys = rng.split(rng.split(kt, n), 8)                  # (n, 8, 2)
    got = rng.randint(keys, (16,), 0, torch.tensor(bounds))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for i, m in enumerate(bounds):
        assert torch.equal(got[i], rng.randint(keys[i], (16,), 0, m))


def test_bernoulli_tensor_probability_bit_exact():
    """Per-row probabilities (a sweep group's link budgets) draw what
    each row's float draws."""
    kj, kt = _k(4)
    p = (0.2, 0.93, 0.5)
    keys = rng.split(kt, 3)
    got = rng.bernoulli(keys, torch.tensor(p, dtype=torch.float32), (4, 9))
    want = jax.vmap(lambda k, q: jax.random.bernoulli(k, q, (4, 9)))(
        jax.random.split(kj, 3), jnp.asarray(p, jnp.float32))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for i, q in enumerate(p):
        assert torch.equal(got[i], rng.bernoulli(keys[i], q, (4, 9)))


def test_uniform_and_bernoulli_exact():
    kj, kt = _k(11)
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(kj, (4096,))),
                                  rng.uniform(kt, (4096,)).numpy())
    tiny = float(jnp.finfo(jnp.float32).tiny)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(kj, (64,), minval=tiny, maxval=1.0)),
        rng.uniform(kt, (64,), tiny, 1.0).numpy())
    for p in (0.3, 0.9977, 0.00123):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(kj, p, (10, 100))),
            rng.bernoulli(kt, p, (10, 100)).numpy())


def _ulps(a, b):
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    return np.abs(a.astype(np.float64) - b) / np.spacing(
        scale.astype(np.float32))


def test_normal_within_4_ulps():
    kj, kt = _k(5)
    want = np.asarray(jax.random.normal(kj, (100_000,)))
    got = rng.normal(kt, (100_000,)).numpy()
    assert _ulps(want, got).max() <= 4


def test_gumbel_within_4_ulps():
    kj, kt = _k(5)
    want = np.asarray(jax.random.gumbel(kj, (10, 5000)))
    got = rng.gumbel(kt, (10, 5000)).numpy()
    assert _ulps(want, got).max() <= 4


@pytest.mark.parametrize("n,k", [(300, 6), (500, 10), (10, 10), (1, 1)])
def test_choice_without_replacement_bit_exact(n, k):
    kj, kt = _k(9)
    keys = jax.random.split(kj, 4)
    want = jax.vmap(lambda kk: jax.random.choice(
        kk, n, (k,), replace=False))(keys)
    got = rng.choice(rng.split(kt, 4), n, (k,), replace=False)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.permutation(kj, n)),
        rng.permutation(kt, n).numpy())


def test_rng_follows_the_key_device():
    kt = rng.PRNGKey(1, device="cpu")
    assert rng.uniform(kt, (3,)).device == torch.device("cpu")
    assert rng.randint(rng.split(kt, 2), (3,), 0, 9).shape == (2, 3)


def test_randint_refuses_spans_of_2_31_on_the_host():
    """An int bound is checked by randint; a tensor bound by its builder
    with check_span, on the host, so the CPU and the card refuse the
    same bounds."""
    key = rng.PRNGKey(0)
    with pytest.raises(NotImplementedError, match="2\\*\\*31"):
        rng.randint(key, (2,), 0, 2 ** 31)
    with pytest.raises(NotImplementedError, match="2\\*\\*31"):
        rng.check_span(-1, 2 ** 31 - 1)
    rng.check_span(0, 2 ** 31 - 1)
    assert rng.randint(key, (2,), 0, 2 ** 31 - 1).shape == (2,)
