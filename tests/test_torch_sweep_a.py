"""The port's sweep engine against the port's per-point loop
(``run_pointwise``: one ``FederatedTrainer.run`` per grid point), case
for case with the reference's tests/test_sweep.py at its sizes and
bounds: acc and loss within atol 1e-6, latency within rtol 1e-6,
uplink_ok and converged_round equal.  The heterogeneous, codec, model
and task grids are in test_torch_sweep_b; the seed-prep memo in
test_torch_seed_memo."""
import numpy as np
import pytest
import torch

from repro_torch.channel import ChannelConfig
from repro_torch.core.program import GridRoundProgram, ProgramOptions
from repro_torch.core.protocols import FederatedConfig
from repro_torch.models import CNN
from repro_torch.sweep import (CH_SWEEPABLE, FED_SWEEPABLE, SweepRunner,
                               engine_stats, make_grid, run_pointwise,
                               run_sweep)
from test_torch_reference import golden_data
from test_torch_reference import one_thread_per_module  # noqa: F401
from torch_ranks import one_rank_group  # noqa: F401

CH = ChannelConfig(num_devices=4, p_up_dbm=40.0)


@pytest.fixture(scope="module")
def data():
    return golden_data()


def _base(**kw):
    cfg = dict(protocol="mix2fld", num_devices=4, local_iters=8,
               local_batch=16, server_iters=8, server_batch=16,
               max_rounds=3, n_seed=6, n_inverse=12, seed=0)
    cfg.update(kw)
    return FederatedConfig(**cfg)


def assert_equivalent(result, histories):
    """The reference's sweep-vs-loop bounds (tests/test_sweep.py)."""
    for g, h in enumerate(histories):
        sh = result.history(g)
        np.testing.assert_allclose(sh["acc"], h["acc"], atol=1e-6,
                                   err_msg=f"acc, point {g}")
        np.testing.assert_allclose(sh["loss"], h["loss"], atol=1e-6,
                                   err_msg=f"loss, point {g}")
        np.testing.assert_allclose(sh["round_latency_s"],
                                   h["round_latency_s"], rtol=1e-6,
                                   err_msg=f"latency, point {g}")
        assert sh["uplink_ok"] == h["uplink_ok"], f"uplink_ok, point {g}"
        assert sh["converged_round"] == h["converged_round"], \
            f"converged_round, point {g}"


def sweep_and_loop(grid, data, model=None):
    res = run_sweep(model, grid, *data, device="cpu")
    return res, run_pointwise(model, grid, *data, device="cpu")


def test_sweep_matches_loop_2x3(data):
    """The headline grid: eta x ragged server_iters (the masked
    conversion steps) in one program, one local and one conversion
    capture."""
    grid = make_grid(_base(), CH, eta=(0.01, 0.02), server_iters=(6, 8, 12))
    assert grid.shape == (2, 3) and grid.size == 6
    engine_stats.reset()
    runner = SweepRunner(CNN(), grid, *data, device="cpu")
    res = runner.run()
    assert engine_stats.programs == 1 and engine_stats.captures == 2
    (_, _, prog), = runner.groups
    lt = prog.step.local_trains[0].train
    (buf,) = lt.steps.buffers
    assert buf.inputs["idx"].shape == (6 * 4, 8, 16)    # G D stacked rows
    assert buf.inputs["x"].shape[0] == 4                # shared, not copied
    assert_equivalent(res, run_pointwise(CNN(), grid, *data, device="cpu"))


@pytest.mark.parametrize("where", ["config", "mesh_shape"])
def test_sharded_grids_name_a13(data, where, one_rank_group):
    """The reference's shard_devices sweeps and its 2-D grid mesh (A13)
    run: on one rank, a ``shard_devices`` grid puts its device axis on a
    one-shard ("data",) mesh and equals the per-point sharded loop
    (``tests/test_sweep.py:78-90``); a ``mesh_shape`` request fits to
    (1, 1) and equals the vmapped sweep bit for bit."""
    if where == "config":
        grid = make_grid(_base(shard_devices=True), CH, eta=(0.01, 0.02))
        runner = SweepRunner(CNN(), grid, *data, device="cpu")
        assert tuple(runner.mesh.shape) == (1,)
        assert_equivalent(runner.run(),
                          run_pointwise(CNN(), grid, *data, device="cpu"))
        return
    grid = make_grid(_base(), CH, eta=(0.01, 0.02))
    runner = SweepRunner(CNN(), grid, *data, device="cpu",
                         options=ProgramOptions(mesh_shape=(2, 1)))
    assert runner.mesh is None
    assert [p.mesh_shape for _, _, p in runner.groups] == [(1, 1)]
    got, want = runner.run(), run_sweep(CNN(), grid, *data, device="cpu")
    np.testing.assert_array_equal(got.acc, want.acc)
    np.testing.assert_array_equal(got.loss, want.loss)
    prog = GridRoundProgram(None, {}, ProgramOptions(mesh_shape=(1, 1)))
    assert prog.options.mesh_shape == (1, 1)


def test_sweep_matches_loop_fl_channel_axis(data):
    """A p_up_dbm axis batches both channel regimes into one draw; each
    matches its loop run and the two regimes draw differently."""
    grid = make_grid(_base(protocol="fl"), CH, p_up_dbm=(23.0, 40.0))
    res, hs = sweep_and_loop(grid, data, CNN())
    assert_equivalent(res, hs)
    assert res.history(0)["round_latency_s"] != \
        res.history(1)["round_latency_s"]


def test_sweep_matches_loop_fd(data):
    grid = make_grid(_base(protocol="fd"), CH, beta=(0.005, 0.02))
    assert_equivalent(*sweep_and_loop(grid, data, CNN()))


def test_sweep_total_outage_never_converges_and_matches_loop(data):
    """An unreachable SNR target outages every link every round: the
    frozen global state is not convergence, even at an eps any rel
    passes."""
    grid = make_grid(_base(protocol="fd", eps=10.0), CH, theta=(3.0, 1e9))
    res, hs = sweep_and_loop(grid, data, CNN())
    assert_equivalent(res, hs)
    h_ok, h_out = res.history(0), res.history(1)
    assert all(n > 0 for n in h_ok["uplink_ok"])
    assert h_ok["converged_round"] == 2
    assert h_out["uplink_ok"] == [0, 0, 0]
    assert h_out["converged_round"] is None


@pytest.mark.parametrize("protocol,axes", [
    ("fld", dict(n_seed=(4, 6))),
    ("mixfld", dict(lam=(0.1, 0.3))),
])
def test_sweep_matches_loop_fld_family(data, protocol, axes):
    """Ragged seed sets (padded, ``n_train`` bounding the draws) and
    MixFLD's soft labels."""
    grid = make_grid(_base(protocol=protocol), CH, **axes)
    assert_equivalent(*sweep_and_loop(grid, data, CNN()))


def test_sweep_warm_rerun_is_deterministic(data):
    """A second run() reuses the group's steps: nothing is built or
    captured, and the histories are equal bit for bit."""
    grid = make_grid(_base(), CH, eta=(0.01, 0.02))
    engine_stats.reset()
    runner = SweepRunner(CNN(), grid, *data, device="cpu")
    r1 = runner.run()
    built = (engine_stats.programs, engine_stats.captures)
    r2 = runner.run()
    assert (engine_stats.programs, engine_stats.captures) == built == (1, 2)
    for k in ("acc", "loss", "latency_s", "up_ok", "converged"):
        np.testing.assert_array_equal(getattr(r1, k), getattr(r2, k))


def test_one_step_serves_every_eta(data):
    """eta, beta and the rows are step inputs: a second grid's values
    replay the same step buffers (no capture per eta, unlike a step that
    bakes eta in)."""
    runner = SweepRunner(CNN(), make_grid(_base(), CH, eta=(0.01, 0.03)),
                         *data, device="cpu")
    runner.run()
    (_, _, prog), = runner.groups
    lt = prog.step.local_trains[0].train
    (buf,) = lt.steps.buffers
    eta = buf.inputs["eta"].view(2, 4)
    assert torch.equal(eta, torch.tensor([[0.01] * 4, [0.03] * 4]))
    assert len(lt.graphs) == 1 and len(prog.step.conversion.graphs) == 1


def test_make_grid_rejects_bad_axes():
    fc = _base()
    with pytest.raises(ValueError, match="static"):
        make_grid(fc, CH, num_devices=(4, 8))
    with pytest.raises(ValueError, match="static"):
        make_grid(fc, CH, t_max_slots=(10, 100))
    with pytest.raises(ValueError, match="unknown"):
        make_grid(fc, CH, nonsense=(1, 2))
    with pytest.raises(ValueError, match="no values"):
        make_grid(fc, CH, eta=())


def test_make_grid_points_follow_c_order():
    grid = make_grid(_base(), CH, eta=(0.01, 0.02), n_seed=(4, 6))
    assert grid.shape == (2, 2)
    assert [fc.eta for fc, _ in grid.points] == [0.01, 0.01, 0.02, 0.02]
    assert [fc.n_seed for fc, _ in grid.points] == [4, 6, 4, 6]
    assert grid.labels()[1] == {"eta": 0.01, "n_seed": 6}
    assert set(FED_SWEEPABLE) & set(CH_SWEEPABLE) == set()


def test_runner_rejects_channel_population_mismatch(data):
    grid = make_grid(_base(), ChannelConfig(num_devices=7), eta=(0.01,))
    with pytest.raises(ValueError, match="devices"):
        SweepRunner(CNN(), grid, *data, device="cpu")


def test_sweep_runs_on_the_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default is the GPU")
    grid = make_grid(_base(), CH, eta=(0.01,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SweepRunner(CNN(), grid, *golden_data())


def test_grouped_conv_over_the_stacked_points_is_bit_equal():
    """The group's local step runs G D devices as one grouped
    convolution where a loop round runs D: on the CPU the stacked
    forward and its gradients equal the per-point ones bit for bit (a
    grouped convolution over G models is not bit-equal to G single-model
    ones, which is why the conversion and the evaluation run each point's
    model alone)."""
    from repro_torch import rng
    cnn = CNN()
    G, D, B = 3, 4, 8
    inits = [cnn.init(rng.PRNGKey(i)) for i in range(G * D)]
    params = {k: {m: torch.stack([p[k][m] for p in inits]) for m in v}
              for k, v in inits[0].items()}
    x = torch.rand(G * D, B, 28, 28, 1,
                   generator=torch.Generator().manual_seed(0))

    def run(tree, xs):
        leaves = [t.clone().requires_grad_(True) for v in tree.values()
                  for t in v.values()]
        it = iter(leaves)
        out = cnn.apply_stacked({k: {m: next(it) for m in v}
                                 for k, v in tree.items()}, xs)
        return [out] + list(torch.autograd.grad((out * out).sum(), leaves))

    full = run(params, x)
    parts = [run({k: {m: t[g * D:(g + 1) * D] for m, t in v.items()}
                  for k, v in params.items()}, x[g * D:(g + 1) * D])
             for g in range(G)]
    for i, t in enumerate(full):
        assert torch.equal(t, torch.cat([p[i] for p in parts]))
