"""The seed-prep memo (``core/seed_prep.py``: ``SeedPrepMemo``,
``prepare_seeds``, ``prep_stats``) and the sweep grids that prep through
it, case for case with the reference's memo tests (tests/test_sweep.py):
an eta or channel axis is one seed group and preps once, an n_seed or
partition axis preps once per value, points of one group share one
result object and one padded row; and the memo counts of the Fig. 2
grid (five protocols x two partitions x two uplink powers) against the
reference's runner."""
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.channel import ChannelConfig
from repro_torch.core.protocols import PROTOCOLS, FederatedConfig
from repro_torch.core.seed_prep import (SEED_FIELDS, SeedPrepMemo,
                                        collect_seeds, partition_fingerprint,
                                        prep_stats, prepare_seeds,
                                        seed_fields_key)
from repro_torch.data import PartitionSpec
from repro_torch.models import CNN
from repro_torch.sweep import SweepRunner, make_grid, run_pointwise
from repro_torch.sweep.engine import _pad_seed_sets
from test_torch_reference import golden_data, golden_pool, load_reference
from test_torch_reference import one_thread_per_module  # noqa: F401
from test_torch_sweep_a import CH, _base, assert_equivalent
from test_torch_sweep_b import HET, HET_PART, het_base


@pytest.fixture(scope="module")
def data():
    return golden_data()


@pytest.fixture(scope="module")
def pool():
    x, y = golden_pool()
    return x[:1200], y[:1200], x[1200:], y[1200:]


def test_seed_fields_are_the_reference_fields():
    ref = load_reference()
    assert SEED_FIELDS == ref.seed_prep.SEED_FIELDS
    fc = _base(eta=0.5, lam=0.3)
    assert seed_fields_key(fc) == tuple(getattr(fc, f) for f in SEED_FIELDS)


def test_fingerprint_is_content_not_identity(data):
    dev_x, dev_y = (torch.tensor(a) for a in data[:2])
    fp = partition_fingerprint(dev_x, dev_y)
    assert partition_fingerprint(dev_x.clone(), dev_y.clone()) == fp
    assert partition_fingerprint(dev_x.numpy(), dev_y.numpy()) == fp
    changed = dev_x.clone()
    changed[0, 0, 0, 0, 0] += 1.0
    assert partition_fingerprint(changed, dev_y) != fp


def test_memo_returns_one_object_per_content(data):
    fc = _base()
    dev_x, dev_y = torch.tensor(data[0]), torch.tensor(data[1]).long()
    key = rng.PRNGKey(5)
    memo = SeedPrepMemo()
    prep_stats.reset()
    a = prepare_seeds(fc, dev_x, dev_y, key, memo=memo)
    b = prepare_seeds(_base(eta=0.3), dev_x, dev_y, key.clone(), memo=memo)
    c = prepare_seeds(_base(n_seed=4), dev_x, dev_y, key, memo=memo)
    assert a is b and a is not c
    assert (memo.misses, memo.hits, prep_stats.runs) == (2, 1, 2)
    plain = prepare_seeds(fc, dev_x, dev_y, key)
    assert plain is not a and prep_stats.runs == 3
    want = collect_seeds(fc, dev_x, dev_y, key)
    for k in ("train_x", "train_y"):
        assert torch.equal(a[k], want[k]) and torch.equal(plain[k], want[k])


def test_eta_only_grid_preps_seeds_exactly_once(data):
    grid = make_grid(_base(), CH, eta=(0.01, 0.02, 0.03))
    assert len(grid.seed_groups()) == 1
    prep_stats.reset()
    runner = SweepRunner(CNN(), grid, *data, device="cpu")
    assert prep_stats.runs == 1
    assert runner.seed_prep_stats == {
        "groups": 1, "prep_runs": 1, "memo_hits": 2}
    assert_equivalent(runner.run(),
                      run_pointwise(CNN(), grid, *data, device="cpu"))


def test_seed_axis_grid_preps_once_per_group(data):
    grid = make_grid(_base(), CH, n_seed=(4, 6), eta=(0.01, 0.02))
    groups = grid.seed_groups()
    assert len(groups) == 2 and all(len(g) == 2 for g in groups.values())
    prep_stats.reset()
    runner = SweepRunner(CNN(), grid, *data, device="cpu")
    assert prep_stats.runs == 2
    assert runner.seed_prep_stats == {
        "groups": 2, "prep_runs": 2, "memo_hits": 2}
    assert runner.seed_sets[0] is runner.seed_sets[1]
    assert runner.seed_sets[2] is runner.seed_sets[3]
    assert runner.seed_sets[0] is not runner.seed_sets[2]
    assert_equivalent(runner.run(),
                      run_pointwise(CNN(), grid, *data, device="cpu"))


def test_channel_only_grid_preps_seeds_exactly_once(data):
    grid = make_grid(_base(protocol="fld"), CH, p_up_dbm=(23.0, 40.0))
    assert len(grid.seed_groups()) == 1
    prep_stats.reset()
    runner = SweepRunner(CNN(), grid, *data, device="cpu")
    assert prep_stats.runs == 1
    assert_equivalent(runner.run(),
                      run_pointwise(CNN(), grid, *data, device="cpu"))


def test_memoized_points_share_padded_seed_rows(data):
    grid = make_grid(_base(), CH, eta=(0.01, 0.02))
    runner = SweepRunner(CNN(), grid, *data, device="cpu")
    assert runner.seed_memo.hits == 1 and runner.seed_memo.misses == 1
    assert runner.seed_sets[0] is runner.seed_sets[1]
    px, py, n = _pad_seed_sets(runner.seed_sets, 10)
    assert torch.equal(px[0], px[1]) and torch.equal(py[0], py[1])
    assert n[0] == n[1]


def test_mixed_hard_and_soft_seed_sets_pad_to_one_hot(data):
    """A lam axis across 0.5 mixes hard (Mix2FLD) and soft (the
    singular-lam fallback) labels: the hard rows become one-hot."""
    grid = make_grid(_base(), CH, lam=(0.1, 0.5))
    runner = SweepRunner(CNN(), grid, *data, device="cpu")
    hard, soft = runner.seed_sets
    assert hard["train_y"].dim() == 1 and soft["train_y"].dim() == 2
    px, py, n = _pad_seed_sets(runner.seed_sets, 10)
    assert py.shape == (2, int(n.max()), 10)
    assert torch.equal(py[0, :n[0]].argmax(-1), hard["train_y"])
    assert_equivalent(runner.run(),
                      run_pointwise(CNN(), grid, *data, device="cpu"))


def test_partition_axis_memoizes_seed_prep_per_partition(pool):
    grid = make_grid(het_base(), CH, PartitionSpec(**HET_PART),
                     partition=("iid", "noniid"), eta=(0.01, 0.02))
    prep_stats.reset()
    runner = SweepRunner(CNN(), grid, *pool, device="cpu")
    assert prep_stats.runs == 2
    assert runner.seed_prep_stats == {
        "groups": 2, "prep_runs": 2, "memo_hits": 2}
    assert runner.seed_sets[0] is runner.seed_sets[1]
    assert runner.seed_sets[2] is runner.seed_sets[3]
    assert runner.seed_sets[0] is not runner.seed_sets[2]


def test_fig2_grid_memo_counts_equal_the_reference(pool):
    """The Fig. 2 grid's structure (benchmarks/bench_protocols.py): five
    protocols x IID / non-IID x p_up 23 / 40 dBm, at the small sizes.
    Three FLD protocols x two partitions are six seed groups, each
    shared across the channel axis: 6 prep runs and 6 memo hits, five
    groups, as the reference's runner counts them."""
    axes = dict(protocol=PROTOCOLS, partition=("iid", "noniid"),
                p_up_dbm=(23.0, 40.0))
    grid = make_grid(het_base(), ChannelConfig(num_devices=4),
                     PartitionSpec(**HET_PART), **axes)
    runner = SweepRunner(CNN(), grid, *pool, device="cpu")
    assert grid.size == 20 and runner.programs == 5
    assert runner.seed_prep_stats == {
        "groups": 6, "prep_runs": 6, "memo_hits": 6}
    ref = load_reference()
    rgrid = ref.sweep.make_grid(
        ref.protocols.FederatedConfig(**HET),
        ref.channel.ChannelConfig(num_devices=4),
        ref.partition.PartitionSpec(**HET_PART), **axes)
    want = ref.sweep.SweepRunner(ref.cnn.CNN(), rgrid, *pool)
    assert runner.seed_prep_stats == want.seed_prep_stats
    assert runner.programs == want.programs
    for g in range(grid.size):
        mine, theirs = runner.seed_sets[g], want.seed_sets[g]
        assert (mine is None) == (theirs is None)
        if mine is not None:
            np.testing.assert_allclose(mine["train_x"].numpy(),
                                       np.asarray(theirs["train_x"]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_array_equal(mine["train_y"].numpy(),
                                          np.asarray(theirs["train_y"]))


def test_seed_fields_cover_sampling(data):
    """Sampled points prep on their round-1 cohort: the sampling fields
    are part of the seed key, so two sample seeds are two groups."""
    with pytest.warns(DeprecationWarning):
        fc = FederatedConfig(**dict(HET, sample_ratio=0.5))
    grid = make_grid(fc, CH, sample_seed=(0, 1))
    assert len(grid.seed_groups()) == 2
