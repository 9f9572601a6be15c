"""The straggler stage and the split link draw against the reference.

``rng.exponential`` is ``-log1p(-uniform)`` as ``jax.random.exponential``
computes it; torch's ``log1p`` may round differently from XLA's, so
values are held to 2 float32 ulps (rtol 2.4e-7; the installed versions
differ by at most one).  The masks, ``n_straggle`` and the uplink
outcomes are equal; latencies are held to rtol 1e-6 as in the round-loop
tests.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.channel import ChannelConfig, LinkPlan
from repro_torch.channel.model import compute_outcomes, slowest_ok_time
from test_torch_reference import load_reference, one_thread_per_module  # noqa: F401


EXP_RTOL = 2.4e-7
KW = dict(n_mod=12490, n_labels=10, sample_bits=6272, n_seed=10)


def _key(kj):
    return torch.tensor(np.asarray(kj), dtype=torch.int64)


@pytest.mark.parametrize("shape", [(1,), (10,), (4, 33), (1000,)])
def test_exponential_matches_jax(shape):
    for seed in range(6):
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
        want = np.asarray(jax.random.exponential(kj, shape))
        got = rng.exponential(_key(kj), shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_allclose(got.numpy(), want, rtol=EXP_RTOL, atol=0)


def test_exponential_takes_a_batch_of_keys():
    kj = jax.random.split(jax.random.PRNGKey(3), 5)
    want = np.asarray(jax.vmap(lambda k: jax.random.exponential(k, (7,)))(
        kj))
    got = rng.exponential(_key(kj), (7,)).numpy()
    np.testing.assert_allclose(got, want, rtol=EXP_RTOL, atol=0)


@pytest.mark.parametrize("mean_s,deadline_s", [
    (0.05, 0.08), (0.05, 0.15), (1.0, 0.7), (0.05, float("inf")),
    (1.0, 1e-6)])   # the last: every device straggles
def test_compute_outcomes_match_reference(mean_s, deadline_s):
    ref = load_reference().channel_model
    for seed in range(8):
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
        t_j, ok_j = ref.compute_outcomes(kj, mean_s, deadline_s, 10)
        t, ok = compute_outcomes(_key(kj), mean_s, deadline_s, 10)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
        np.testing.assert_allclose(t.numpy(), np.asarray(t_j),
                                   rtol=EXP_RTOL, atol=0)
        want = float(ref.slowest_ok_time(t_j, ok_j, deadline_s))
        got = slowest_ok_time(t, ok, deadline_s)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=EXP_RTOL)


@pytest.mark.parametrize("protocol", ["fl", "fd", "mix2fld"])
@pytest.mark.parametrize("first_round", [True, False])
def test_link_plan_draw_with_stragglers_matches_reference(protocol,
                                                          first_round):
    ref = load_reference()
    for mean_s, deadline_s in ((0.05, 0.15), (1.0, 0.7)):
        ch = dict(num_devices=10, p_up_dbm=40.0, compute_mean_s=mean_s,
                  deadline_s=deadline_s)
        plan_j = ref.pipeline.LinkPlan.build(
            protocol, ref.channel.ChannelConfig(**ch), **KW)
        plan_t = LinkPlan.build(protocol, ChannelConfig(**ch), **KW)
        assert (plan_t.compute_mean_s, plan_t.deadline_s) == (
            plan_j.compute_mean_s, plan_j.deadline_s)
        n_straggle = 0
        for seed in range(6):
            kj = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
            want = plan_j.draw(kj, first_round)
            got = plan_t.draw(_key(kj), first_round)
            for k in ("up_ok", "dn_ok", "comp_ok"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got["n_straggle"] == want["n_straggle"]
            np.testing.assert_allclose(got["t_comp_s"], want["t_comp_s"],
                                       rtol=EXP_RTOL, atol=0)
            np.testing.assert_allclose(got["latency_s"], want["latency_s"],
                                       rtol=1e-6)
            n_straggle += got["n_straggle"]
        assert n_straggle > 0  # the stage really dropped devices


def test_straggler_stage_off_draws_nothing_more():
    """At the defaults the draw has no straggler fields, and turning the
    stage on leaves the channel's own outcomes unchanged (its own fold
    of the key)."""
    plan = LinkPlan.build("fd", ChannelConfig(num_devices=4), **KW)
    on = LinkPlan.build("fd", ChannelConfig(num_devices=4,
                                            compute_mean_s=0.05,
                                            deadline_s=0.08), **KW)
    key = rng.fold_in(rng.PRNGKey(5), 3)
    off_out, on_out = plan.draw(key, False), on.draw(key, False)
    assert "n_straggle" not in off_out and "comp_ok" not in off_out
    np.testing.assert_array_equal(off_out["dn_ok"], on_out["dn_ok"])
    np.testing.assert_array_equal(on_out["up_ok"],
                                  off_out["up_ok"] & on_out["comp_ok"])
    assert on_out["latency_s"] >= off_out["latency_s"]


def test_dispatched_draws_collect_in_any_order_to_the_serial_draws():
    """Dispatch several rounds ahead, collect them out of order: each
    equals the serial draw of its key."""
    plan = LinkPlan.build("mix2fld", ChannelConfig(
        num_devices=4, p_up_dbm=40.0, compute_mean_s=0.05,
        deadline_s=0.08), **KW)
    keys = [rng.fold_in(rng.fold_in(rng.PRNGKey(0), q), 3)
            for q in range(1, 5)]
    handles = [plan.dispatch(k, first_round=q == 0)
               for q, k in enumerate(keys)]
    for q in (3, 0, 2, 1):
        got = plan.collect(handles[q])
        want = plan.draw(keys[q], first_round=q == 0)
        for k in ("up_ok", "dn_ok", "comp_ok", "t_comp_s"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["latency_s"] == want["latency_s"]
        assert got["n_straggle"] == want["n_straggle"]


def test_dispatch_on_the_cpu_uses_no_stream():
    plan = LinkPlan.build("fd", ChannelConfig(num_devices=4), **KW)
    handle = plan.dispatch(rng.PRNGKey(1), first_round=True)
    assert "event" not in handle
    assert handle["out"]["latency_s"].dtype == torch.float32
