"""The sweep engine on meshes of gloo ranks on the CPU, and the FD sync
over a pod mesh, held to the reference's contracts
(``tests/test_mesh2d.py``, ``tests/test_sweep.py:78-103``,
``src/repro/launch/steps.py:241-271``): a (2, 1) (grid, data) mesh is
the vmapped sweep bit for bit (grid shards share no reduction); (1, 2)
and (2, 2) are the 1-D 2-shard ``shard_devices`` sweep within 1e-6 (the
same reduction widths); (1, 2) is the live reference's vmapped sweep
within 1e-4; the shard-mapped FD sync on 2 ranks is the port's vmapped
sync within 1e-5 and the reference's within 1e-4.  The grid holds fl,
fd and mix2fld, so both aggregations run on every mesh."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs, rng
from repro_torch.channel import ChannelConfig
from repro_torch.core.program import ProgramOptions
from repro_torch.core.protocols import FederatedConfig
from repro_torch.data import partition_iid, synthetic_images
from repro_torch.launch import steps
from repro_torch.models import CNN, transformer
from repro_torch.sweep import SweepRunner, make_grid, run_sweep
from test_torch_reference import (GOLDEN_CFG, load_reference,
                                  one_thread_per_module)  # noqa: F401
from torch_ranks import fd_sync_run, one_rank_group, start, sweep_runs  # noqa: F401,E501

BASE = dict(GOLDEN_CFG, protocol="mix2fld")
AXES = dict(protocol=("fl", "fd", "mix2fld"), eta=(0.01, 0.02))
CH = dict(num_devices=4, p_up_dbm=40.0)
KS_ITERS = 4


def sorted_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    return [tree]


@functools.lru_cache(maxsize=None)
def golden_data():
    """``tests/test_mesh2d.py``'s data (the golden pool and partition),
    made by the port, so the ranks start before the reference loads."""
    x, y = synthetic_images(rng.PRNGKey(42, "cpu"), 1400, device="cpu")
    dev_x, dev_y = partition_iid(x[:1200].numpy(), y[:1200].numpy(), 4,
                                 300, 10, seed=0)
    return (np.asarray(dev_x), np.asarray(dev_y), x[1200:].numpy(),
            y[1200:].numpy())


@functools.lru_cache(maxsize=None)
def fd_sync_inputs():
    """The qwen2-0.5b smoke config, two pods (pod 1 scaled by 1.5),
    their tables and a seed batch, as numpy."""
    cfg = configs.get_config("qwen2-0.5b").smoke()
    p = transformer.init_params(cfg, rng.PRNGKey(0, "cpu"), device="cpu")
    pods = transformer.tree_map(lambda t: np.stack(
        [t.numpy(), (1.5 * t.float()).to(t.dtype).numpy()]), p)
    rs = np.random.default_rng(2)
    favg = rs.random((2, cfg.fd_buckets, cfg.fd_buckets), np.float32)
    favg /= favg.sum(-1, keepdims=True)
    toks = rs.integers(0, cfg.vocab_size, (4, 32))
    return cfg, pods, favg, {"tokens": toks}


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Every rank's results, by world: 2 ranks run the (2, 1), (1, 2)
    and 1-D sweeps and, apart, the FD sync; 4 ranks the (2, 2) sweep.
    All start before the module's first test."""
    data = golden_data()
    shard = dict(BASE, shard_devices=True)
    worlds = {
        2: start(sweep_runs, 2, tmp_path_factory.mktemp("s2"), data,
                 [(BASE, AXES, (2, 1)), (BASE, AXES, (1, 2)),
                  (shard, AXES, None)]),
        4: start(sweep_runs, 4, tmp_path_factory.mktemp("s4"), data,
                 [(BASE, AXES, (2, 2))]),
        "fd": start(fd_sync_run, 2, tmp_path_factory.mktemp("fd"),
                    *fd_sync_inputs()),
    }
    return lambda w: worlds[w].results()


def vmapped_sweep():
    grid = make_grid(FederatedConfig(**BASE), ChannelConfig(**CH), **AXES)
    return run_sweep(CNN(), grid, *golden_data(), device="cpu")


def assert_match(got, want, atol):
    for k in ("acc", "loss"):
        np.testing.assert_allclose(got[k], getattr(want, k) if not
                                   isinstance(want, dict) else want[k],
                                   rtol=0, atol=atol, err_msg=k)
    for k in ("up_ok", "converged", "latency_s"):
        np.testing.assert_array_equal(
            got[k], want[k] if isinstance(want, dict) else getattr(want, k),
            err_msg=k)


def test_fd_sync_over_a_pod_mesh(ranks):
    """One pod a rank: the (NB, NB) mean is the one collective; each
    rank's converted pod equals the vmapped sync's (1e-5) and the
    reference's (1e-4)."""
    cfg, pods, favg, batch = fd_sync_inputs()
    want_p, want_g = steps.make_fd_sync_step(cfg, 2, ks_iters=KS_ITERS)(
        transformer.params_from_jax(cfg, pods, "cpu"), torch.tensor(favg),
        {"tokens": torch.tensor(batch["tokens"])})
    rc = load_reference()
    ref_p, ref_g = jax.jit(rc.steps.make_fd_sync_step(
        rc.configs.ArchConfig(**dataclasses.asdict(cfg)), 2,
        ks_iters=KS_ITERS))(jax.tree.map(jnp.asarray, pods),
                            jnp.asarray(favg),
                            {"tokens": jnp.asarray(batch["tokens"])})
    out = ranks("fd")
    for r, got in enumerate(out):
        assert [k for k, _, _ in got["records"]] == ["all-reduce"]
        assert got["records"][0][1] == cfg.fd_buckets ** 2 * 4
        np.testing.assert_allclose(got["gout"][0], want_g.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["gout"][0], np.asarray(ref_g),
                                   rtol=0, atol=1e-4)
        for g, w, rf in zip(sorted_leaves(got["params"]),
                            sorted_leaves(want_p), sorted_leaves(ref_p)):
            np.testing.assert_allclose(g[0], w[r].numpy(), rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(g[0], np.asarray(rf)[r], rtol=0,
                                       atol=1e-4)


def test_data_sharded_sweep_matches_live_reference(ranks):
    """(1, 2) against the reference's vmapped ``SweepRunner`` run live,
    within its multichip bound (``tests/test_sweep.py:93-103``): the
    grid's Mix2FLD group (each group is a program of its own, so its
    points do not depend on the others)."""
    ref = load_reference()
    grid = ref.sweep.make_grid(
        ref.protocols.FederatedConfig(**BASE),
        ref.channel.ChannelConfig(**CH), eta=AXES["eta"])
    dev_x, dev_y, tx, ty = golden_data()
    want = ref.sweep.SweepRunner(None, grid, dev_x, dev_y, jnp.asarray(tx),
                                 jnp.asarray(ty)).run()
    port_grid = make_grid(FederatedConfig(**BASE), ChannelConfig(**CH),
                          **AXES)
    rows = [g for g, (fc, _) in enumerate(port_grid.points)
            if fc.protocol == "mix2fld"]
    assert len(rows) == 2
    got = {k: v[rows] for k, v in ranks(2)[0][1].items()
           if k in ("acc", "loss", "up_ok", "converged")}
    np.testing.assert_allclose(got["acc"], np.asarray(want.acc), atol=1e-4)
    np.testing.assert_allclose(got["loss"], np.asarray(want.loss),
                               atol=1e-4)
    np.testing.assert_array_equal(got["up_ok"], np.asarray(want.up_ok))
    np.testing.assert_array_equal(got["converged"],
                                  np.asarray(want.converged))


def test_grid_axis_sharding_is_bitwise_vmapped(ranks):
    """tests/test_mesh2d.py:126-145 on 2 ranks."""
    want = vmapped_sweep()
    for r, out in enumerate(ranks(2)):
        got = out[0]
        assert got["mesh_shapes"] == [(2, 1)] * 3 and got["programs"] == 3
        assert_match(got, want, atol=0)
        np.testing.assert_array_equal(got["acc"], want.acc)


def test_2d_mesh_matches_1d_device_sharding(ranks):
    """tests/test_mesh2d.py:147-163: (1, 2) on 2 ranks and (2, 2) on 4
    against the 1-D 2-shard sweep, within 1e-6."""
    one_d = ranks(2)[0][2]
    assert one_d["runner_mesh"] == (2,) and one_d["mesh_shapes"] == [(2,)] * 3
    for out, shape in ((ranks(2)[0][1], (1, 2)), (ranks(4)[0][0], (2, 2))):
        assert out["mesh_shapes"] == [shape] * 3 and out["programs"] == 3
        assert_match(out, one_d, atol=1e-6)


def test_every_rank_holds_the_same_results(ranks):
    for world in (2, 4):
        out = ranks(world)
        for r in range(1, world):
            for a, b in zip(out[0], out[r]):
                for k in ("acc", "loss", "latency_s", "up_ok", "converged"):
                    np.testing.assert_array_equal(a[k], b[k])


def test_runner_clamps_oversized_mesh_request(one_rank_group):
    """tests/test_mesh2d.py:91-105 on one rank: a request beyond the
    world's ranks degrades to what divides and fits."""
    grid = make_grid(FederatedConfig(**BASE), ChannelConfig(**CH),
                     eta=(0.01, 0.02))
    runner = SweepRunner(CNN(), grid, *golden_data()[:2], *golden_data()[2:],
                         options=ProgramOptions(mesh_shape=(64, 64)),
                         device="cpu")
    assert [p.mesh_shape for _, _, p in runner.groups] == [(1, 1)]
