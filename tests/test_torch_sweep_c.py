"""Structural sweep axes on the port: the codec family (one group per
family, the numeric codec parameters per point; against the port's loop
and the reference's ``SweepRunner`` run live), the DP ledger, FL's
parameter codecs, the model and task axes (registry-built groups,
per-task pools), a mixed CNN + MLP cohort (one captured local step per
architecture group) and client sampling (``sample_ratio`` 0.5), at the
reference's sizes and bounds (see test_torch_sweep_a and _b)."""
import numpy as np
import pytest

from repro_torch.core.privacy import gaussian_epsilon
from repro_torch.core.protocols import PROTOCOLS
from repro_torch.data import PartitionSpec
from repro_torch.models import CNN
from repro_torch.sweep import (SweepRunner, engine_stats, make_grid,
                               make_task_data, run_pointwise, run_sweep)
from test_torch_reference import golden_data
from test_torch_reference import one_thread_per_module  # noqa: F401
from test_torch_sweep_a import CH, assert_equivalent
from test_torch_sweep_b import (HET_PART, assert_matches_reference,
                                het_base, reference_sweep)


@pytest.fixture(scope="module")
def data():
    return golden_data()


def test_codec_axis_matches_loop_and_live_reference(data):
    """protocol x codec family x quant_bits: four groups (2 protocols x
    2 families), the bit widths per point inside the quantize groups;
    every point equals its loop run, and the grid the reference's."""
    axes = dict(protocol=("fd", "mix2fld"), codec=("identity", "quantize"),
                quant_bits=(4, 8))
    grid = make_grid(het_base(), CH, **axes)
    assert grid.shape == (2, 2, 2)
    assert len(grid.program_groups()) == 4
    assert len(grid.protocol_groups()) == 2
    engine_stats.reset()
    runner = SweepRunner(CNN(), grid, *data, device="cpu")
    assert runner.programs == 4
    res = runner.run()
    assert engine_stats.captures == 4 + 2
    assert_equivalent(res, run_pointwise(CNN(), grid, *data, device="cpu"))
    for row in res.frames():
        assert row["dp_epsilon"] is None
        want = 100 * (row["quant_bits"] if row["codec"] == "quantize"
                      else 32)
        assert row["uplink_bits"] == want

    want_runner, want = reference_sweep(axes, data, part=False)
    assert runner.programs == want_runner.programs
    assert runner.seed_prep_stats == want_runner.seed_prep_stats
    assert_matches_reference(res, want)


def test_dp_codec_grid_accounts_epsilon(data):
    """dp_sigma per point inside one dp_gaussian group; the frames carry
    the closed-form epsilon and the ledgers of the loop path."""
    grid = make_grid(het_base(), CH, codec=("dp_gaussian",),
                     dp_sigma=(0.5, 2.0))
    runner = SweepRunner(CNN(), grid, *data, device="cpu")
    assert runner.programs == 1
    res = runner.run()
    hs = run_pointwise(CNN(), grid, *data, device="cpu")
    assert_equivalent(res, hs)
    rows = res.frames()
    R = grid.points[0][0].max_rounds
    for g, (row, sigma) in enumerate(zip(rows, (0.5, 2.0))):
        assert row["dp_epsilon"] == pytest.approx(
            gaussian_epsilon(sigma, 1e-5, R))
        assert res.history(g)["dp"] == hs[g]["dp"]
    assert rows[0]["dp_epsilon"] > rows[1]["dp_epsilon"]


def test_fl_parameter_codecs_match_loop(data):
    """FL codes the devices' parameters: quantize (per-point levels),
    delta (each device's global reference) and dp_gaussian (per-point
    noise and clip), one group each."""
    grid = make_grid(het_base(protocol="fl"), CH,
                     codec=("quantize", "delta", "dp_gaussian"),
                     quant_bits=(4, 8), dp_clip=(0.5, 1.0))
    runner = SweepRunner(CNN(), grid, *data, device="cpu")
    assert runner.programs == 3
    assert_equivalent(runner.run(),
                      run_pointwise(CNN(), grid, *data, device="cpu"))


def test_model_task_axes_match_loop_per_group():
    """protocol x model x task: one program per structural group, each
    point equal to its loop run on registry-built models and per-task
    pools."""
    grid = make_grid(het_base(), CH, PartitionSpec(**HET_PART),
                     protocol=("fd", "mix2fld"), model=("cnn", "mlp"),
                     task=("digits", "speech"))
    assert grid.tasked and grid.partitioned and grid.size == 8
    td = make_task_data(grid, device="cpu")
    engine_stats.reset()
    runner = SweepRunner(None, grid, task_data=td, device="cpu")
    assert runner.programs == len(grid.program_groups()) == 8
    res = runner.run()
    res2 = runner.run()
    assert engine_stats.captures == 8 + 4
    np.testing.assert_array_equal(res.acc, res2.acc)
    assert_equivalent(res, run_pointwise(None, grid, task_data=td,
                                         device="cpu"))
    rows = res.frames()
    assert {r["model"] for r in rows} == {"cnn", "mlp"}
    assert {r["task"] for r in rows} == {"digits", "speech"}


def test_mixed_architecture_cohort_matches_loop():
    """A CNN + MLP cohort: one captured local step per architecture
    group, the tables reassembled for eq. (2), the converted model
    delivered to the server architecture's devices only."""
    grid = make_grid(het_base(protocol="fd"), CH, PartitionSpec(**HET_PART),
                     protocol=("fd", "mix2fld"), model=("cnn", "cnn+mlp"))
    td = make_task_data(grid, device="cpu")
    engine_stats.reset()
    runner = SweepRunner(None, grid, task_data=td, device="cpu")
    assert runner.programs == 4
    res = runner.run()
    # local steps: 1 + 2 per protocol; conversions: mix2fld's two groups
    assert engine_stats.captures == 2 * (1 + 2) + 2
    assert_equivalent(res, run_pointwise(None, grid, task_data=td,
                                         device="cpu"))
    assert res.history(1)["model"] == "cnn+mlp"
    assert not np.allclose(res.loss[0], res.loss[1])
    with pytest.raises(ValueError, match="cannot mix architectures"):
        het_base(protocol="fl", model="cnn+mlp")
    with pytest.raises(NotImplementedError, match="A15"):
        make_grid(het_base(protocol="fd"), CH,
                  model=("cnn+mlp+transformer",))


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_sampled_grid_matches_loop(data):
    """sample_ratio 0.5: the group trains each point's cohort of 2 of
    the 4 devices (drawn on the host per point), gathered off the pool
    and scattered back; a sample_seed axis batches inside the group."""
    grid = make_grid(het_base(max_rounds=3), CH,
                     protocol=("fl", "mix2fld"), sample_ratio=(0.5,),
                     sample_seed=(0, 1))
    runner = SweepRunner(CNN(), grid, *data, device="cpu")
    assert runner.programs == 2
    res = runner.run()
    hs = run_pointwise(CNN(), grid, *data, device="cpu")
    assert_equivalent(res, hs)
    assert all(h["cohort_size"] == 2 for h in hs)


def test_registry_models_equal_the_explicit_cnn(data):
    """model=None builds the CNN from the registry: the five-protocol
    grid's histories equal the explicit CNN()'s bit for bit."""
    grid = make_grid(het_base(), CH, protocol=PROTOCOLS)
    res = run_sweep(None, grid, *data, device="cpu")
    res_explicit = run_sweep(CNN(), grid, *data, device="cpu")
    np.testing.assert_array_equal(res.acc, res_explicit.acc)
    np.testing.assert_array_equal(res.loss, res_explicit.loss)
    for g in range(grid.size):
        h = res.history(g)
        assert h["model"] == "cnn" and h["task"] == "digits"


def test_model_task_axes_validate(data):
    dev_x, dev_y, tx, ty = data
    with pytest.raises(ValueError, match="unknown model"):
        make_grid(het_base(), CH, model=("cnn", "resnet"))
    with pytest.raises(ValueError, match="unknown task"):
        make_grid(het_base(), CH, task=("digits", "imagenet"))
    grid = make_grid(het_base(), CH, PartitionSpec(**HET_PART),
                     model=("cnn", "mlp"))
    with pytest.raises(ValueError, match="pass model=None"):
        SweepRunner(CNN(), grid, dev_x, dev_y, tx, ty, device="cpu")
    tgrid = make_grid(het_base(), CH, task=("digits", "cifar"))
    with pytest.raises(ValueError, match="per-task"):
        SweepRunner(None, tgrid, dev_x, dev_y, tx, ty, device="cpu")
