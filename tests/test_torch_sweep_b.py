"""Heterogeneous sweep grids on the port: the five protocols x two
partitions in one runner (five groups, each one program), against the
port's per-point loop at the reference's bounds (see
test_torch_sweep_a) and against the reference's ``SweepRunner`` run
live on the same grid (loss and acc within 1e-4, latency, uplink_ok and
converged_round equal, the same program count and seed-prep counts);
ragged ``n_local`` partitions; the data checks and the result frames."""
import json

import numpy as np
import pytest

from repro_torch.channel import ChannelConfig
from repro_torch.core.protocols import PROTOCOLS, FederatedConfig
from repro_torch.core.seed_prep import prep_stats
from repro_torch.data import PartitionSpec
from repro_torch.models import CNN
from repro_torch.sweep import (CH_SWEEPABLE, FED_SWEEPABLE, PART_SWEEPABLE,
                               SweepRunner, engine_stats, make_grid,
                               run_pointwise, run_sweep)
from test_torch_reference import golden_data, golden_pool, load_reference
from test_torch_reference import one_thread_per_module  # noqa: F401
from test_torch_sweep_a import CH, assert_equivalent

# tests/test_sweep.py's tiny budgets: a 10-point grid against 10 loop runs
HET = dict(protocol="mix2fld", num_devices=4, local_iters=2,
           local_batch=16, server_iters=2, server_batch=16, max_rounds=2,
           n_seed=4, n_inverse=8, seed=0)
# noniid n_local must satisfy 2*2 + 8*common; 60 = 4 + 8*7
HET_PART = dict(scheme="iid", n_local=60, seed=0)


def het_base(**kw):
    return FederatedConfig(**dict(HET, **kw))


@pytest.fixture(scope="module")
def pool():
    x, y = golden_pool()
    return x[:1200], y[:1200], x[1200:], y[1200:]


def reference_sweep(grid_axes, pool, base=None, part=True):
    """The reference's SweepRunner on the same grid, run live."""
    ref = load_reference()
    fc = ref.protocols.FederatedConfig(**dict(HET, **(base or {})))
    ch = ref.channel.ChannelConfig(num_devices=4, p_up_dbm=40.0)
    spec = ref.partition.PartitionSpec(**HET_PART) if part else None
    grid = ref.sweep.make_grid(fc, ch, spec, **grid_axes)
    runner = ref.sweep.SweepRunner(ref.cnn.CNN(), grid, *pool)
    return runner, runner.run()


def assert_matches_reference(got, want):
    np.testing.assert_allclose(got.loss, want.loss, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.acc, want.acc, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.latency_s, want.latency_s, rtol=1e-6)
    np.testing.assert_array_equal(got.up_ok, want.up_ok)
    np.testing.assert_array_equal(got.converged, want.converged)
    np.testing.assert_array_equal(got.up_bits, want.up_bits)
    np.testing.assert_array_equal(got.up_bits_first, want.up_bits_first)


def test_heterogeneous_grid_matches_loop_and_live_reference(pool):
    """The acceptance grid: all five protocols x IID / non-IID in one
    runner.  One program per protocol, one local capture per group and
    one conversion capture per FLD-family group, seed prep once per
    (FLD protocol, partition); the loop's histories within 1e-6 and the
    reference's sweep within 1e-4."""
    axes = dict(protocol=PROTOCOLS, partition=("iid", "noniid"))
    grid = make_grid(het_base(), CH, PartitionSpec(**HET_PART), **axes)
    assert grid.shape == (5, 2) and grid.partitioned
    prep_stats.reset()
    engine_stats.reset()
    runner = SweepRunner(CNN(), grid, *pool, device="cpu")
    assert runner.seed_prep_stats == {
        "groups": 6, "prep_runs": 6, "memo_hits": 0}
    assert prep_stats.runs == 6
    assert runner.programs == len(PROTOCOLS)
    res = runner.run()
    res2 = runner.run()
    assert engine_stats.captures == len(PROTOCOLS) + 3
    np.testing.assert_array_equal(res.acc, res2.acc)
    assert_equivalent(res, run_pointwise(CNN(), grid, *pool, device="cpu"))

    want_runner, want = reference_sweep(axes, pool)
    assert runner.programs == want_runner.programs
    assert runner.seed_prep_stats == want_runner.seed_prep_stats
    assert_matches_reference(res, want)


def test_ragged_n_local_axis_pads_and_masks(pool):
    """Ragged partitions stack padded to the largest; each point's
    n_local bounds its draws, so every point equals its loop run."""
    grid = make_grid(het_base(), CH, n_local=(60, 100))
    assert grid.partitioned
    runner = SweepRunner(CNN(), grid, *pool, device="cpu")
    assert runner.seed_prep_stats["prep_runs"] == 2
    (_, _, prog), = runner.groups
    assert prog.step.dev_x.shape[:2] == (2 * 4, 100)
    assert_equivalent(runner.run(),
                      run_pointwise(CNN(), grid, *pool, device="cpu"))


def test_protocol_axis_validates_names():
    with pytest.raises(ValueError, match="mix2lfd.*not a registered"):
        make_grid(het_base(), CH, protocol=("fl", "mix2lfd"))
    with pytest.raises(ValueError, match="zstd.*not a registered codec"):
        make_grid(het_base(), CH, codec=("identity", "zstd"))
    with pytest.raises(ValueError, match="not a registered partition"):
        make_grid(het_base(), CH, partition=("iid", "pathological"))
    with pytest.raises(ValueError, match="unknown field.*partition"):
        make_grid(het_base(), CH, protocl=("fl",))
    assert not (set(PART_SWEEPABLE)
                & (set(FED_SWEEPABLE) | set(CH_SWEEPABLE)))


def test_axis_errors_are_the_reference_messages():
    """The same grids refused with the same messages as the
    reference's make_grid."""
    ref = load_reference()
    rbase = ref.protocols.FederatedConfig(**HET)
    rch = ref.channel.ChannelConfig(num_devices=4)
    for axes in (dict(protocol=("fl", "mix2lfd")), dict(eta=()),
                 dict(partition=("iid", "pathological")),
                 dict(num_devices=(4, 8)), dict(protocl=("fl",)),
                 dict(task=("digits", "imagenet"))):
        with pytest.raises(ValueError) as want:
            ref.sweep.make_grid(rbase, rch, **axes)
        with pytest.raises(ValueError) as got:
            make_grid(het_base(), ChannelConfig(num_devices=4), **axes)
        assert str(got.value) == str(want.value), axes


def test_partitioned_grid_rejects_prepartitioned_data(pool):
    px, py, tx, ty = pool
    dev_x, dev_y, _, _ = golden_data()
    grid = make_grid(het_base(), CH, partition=("iid", "noniid"))
    with pytest.raises(ValueError, match="flat sample pool"):
        SweepRunner(CNN(), grid, dev_x, dev_y, tx, ty, device="cpu")
    plain = make_grid(het_base(), CH, eta=(0.01,))
    with pytest.raises(ValueError, match="pre-partitioned"):
        SweepRunner(CNN(), plain, px, py, tx, ty, device="cpu")


def test_heterogeneous_frames_carry_axis_labels(pool):
    grid = make_grid(het_base(), CH, PartitionSpec(**HET_PART),
                     protocol=("fl", "mix2fld"), partition=("iid",))
    res = run_sweep(CNN(), grid, *pool, device="cpu")
    assert [r["protocol"] for r in res.frames()] == ["fl", "mix2fld"]
    assert res.to_payload()["protocols"] == ["fl", "mix2fld"]
    assert res.history(1)["protocol"] == "mix2fld"


def test_result_frames_and_payload():
    from test_torch_sweep_a import _base
    grid = make_grid(_base(), CH, n_seed=(4, 6))
    res = run_sweep(CNN(), grid, *golden_data(), device="cpu")
    rows = res.frames()
    assert len(rows) == 2 and rows[0]["n_seed"] == 4
    assert all(np.isfinite(r["final_acc"]) for r in rows)
    assert all(len(r["acc"]) == 3 for r in rows)
    # cum_time_s spreads the sweep's wall time over the channel latency
    assert rows[0]["cum_time_s"] > sum(res.history(0)["round_latency_s"])
    assert json.loads(json.dumps(res.to_payload()))["grid_shape"] == [2]
