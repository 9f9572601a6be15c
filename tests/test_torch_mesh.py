"""The port's meshes (``launch/mesh.py``) and federated placements
(``launch/sharding.py``) against the reference's, run live, in one
process (one rank; the multi-rank runs are in ``test_torch_sharded*.py``):
``grid_mesh_shape`` over a sweep of (G, D, avail, shape) with its
errors, the meshes' dims and shapes, the placements of the reference's
PartitionSpecs, and the collectives' records."""
import itertools
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch import mesh, sharding
from test_torch_reference import load_reference
from torch_ranks import launcher_rank, one_rank_group  # noqa: F401


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("avail", [1, 2, 3, 4, 6, 8])
def test_grid_mesh_shape_matches_reference(avail):
    ref = load_reference().mesh
    shapes = [None, (1, 1), (2, 1), (1, 2), (2, 2), (3, 2), (0, 4), (4, 4)]
    for G, D, shape in itertools.product(range(1, 9), (1, 2, 4, 6, 10),
                                         shapes):
        got = _outcome(mesh.grid_mesh_shape, G, D, shape=shape, avail=avail)
        want = _outcome(ref.grid_mesh_shape, G, D, shape=shape, avail=avail)
        assert got == want, (G, D, shape, avail)


def test_largest_divisor_matches_reference():
    ref = load_reference().mesh
    for n, limit in itertools.product(range(1, 25), range(0, 10)):
        assert mesh._largest_divisor(n, limit) == \
            ref._largest_divisor(n, limit)


def test_make_device_mesh_one_rank(one_rank_group):
    m = mesh.make_device_mesh(4, device="cpu")
    assert m.mesh_dim_names == ("data",) and tuple(m.shape) == (1,)
    assert mesh.mesh_coordinate(m) == (0,)
    assert dist.get_backend() == "gloo"       # the CPU's backend
    with pytest.raises(ValueError, match="not divisible by 3"):
        mesh.make_device_mesh(4, 3, device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh.make_device_mesh(4, 2, device="cpu")


@pytest.mark.parametrize("world_size", ["2", "1"])
def test_launcher_environment_decides_the_group(world_size, monkeypatch):
    """With no group running, a launcher's ``WORLD_SIZE`` above 1 is
    joined through ``env://`` and no one-rank group is started; without
    one (or at 1) the process gets a one-rank group."""
    calls = []
    monkeypatch.setenv("WORLD_SIZE", world_size)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    mesh.ensure_process_group("cpu")
    assert len(calls) == 1
    (backend,), kw = calls[0]
    assert backend == "gloo"
    if world_size == "2":
        assert kw == {"init_method": "env://"}
    else:
        assert kw["world_size"] == 1 and kw["rank"] == 0
        assert isinstance(kw["store"], dist.HashStore)


def test_launched_ranks_share_one_mesh(tmp_path):
    """Two ranks started as ``torchrun`` starts them (the environment
    names a world of 2, no group is running): the mesh builder joins
    that world, so the mesh has 2 shards and a sum spans both ranks."""
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(launcher_rank, args=(2, port, str(tmp_path)),
                       nprocs=2, start_method="spawn")
    for r in range(2):
        got = pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
        assert got == {"world": 2, "mesh": (2,), "backend": "gloo",
                       "sum": 3.0}


def test_make_grid_mesh_axes(one_rank_group):
    """tests/test_mesh2d.py::test_make_grid_mesh_axes on one rank."""
    ref = load_reference().mesh
    m = mesh.make_grid_mesh(6, 4, device="cpu")
    assert m.mesh_dim_names == ("grid", "data")
    assert tuple(m.shape) == ref.make_grid_mesh(6, 4).devices.shape
    gs, ds = m.shape
    assert 6 % gs == 0 and 4 % ds == 0 and gs * ds <= mesh.world_size()
    assert mesh.data_axes(m) == ("data",)
    with pytest.raises(ValueError, match="chips"):
        mesh.make_grid_mesh(2, 4, shape=(2, 1), device="cpu")


def test_pod_mesh_data_axes(one_rank_group):
    m = mesh.make_mesh((1, 1), ("pod", "data"), device="cpu")
    assert mesh.data_axes(m) == ("pod", "data")


def _placements(spec, axes):
    """A PartitionSpec as DTensor placements on a mesh of ``axes``: each
    mesh dim shards the tensor dim that names it, else replicates."""
    out = []
    for ax in axes:
        dims = [i for i, name in enumerate(spec) if name == ax]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def test_federated_pspecs_contract():
    want = load_reference().sharding.federated_pspecs()
    got = sharding.federated_pspecs()
    assert set(got) == set(want)
    for k in want:
        assert got[k] == _placements(want[k], ("data",)), k
    assert want["device"] == P("data") and want["replicated"] == P()


def test_federated_grid_pspecs_contract():
    """tests/test_mesh2d.py::test_federated_grid_pspecs_contract, each
    PartitionSpec as its placements on the ("grid", "data") mesh."""
    want = load_reference().sharding.federated_grid_pspecs()
    got = sharding.federated_grid_pspecs()
    assert set(got) == set(want) == {"gdev", "gcfg", "data", "replicated"}
    for k in want:
        assert got[k] == _placements(want[k], ("grid", "data")), k
    assert got["gdev"] == (Shard(0), Shard(1))
    assert got["gcfg"] == (Shard(0), Replicate())
    assert got["data"] == (Replicate(), Shard(0))
    assert got["replicated"] == (Replicate(), Replicate())


def test_collectives_record_calls_and_bytes(one_rank_group):
    log = mesh.COLLECTIVES
    log.reset()
    x = torch.arange(6, dtype=torch.float32)
    assert torch.equal(mesh.all_reduce_sum(x.clone()), x)
    rows = mesh.all_gather_rows(x.view(2, 3))
    assert rows.shape == (1, 2, 3) and torch.equal(rows[0], x.view(2, 3))
    assert log.calls() == 2 and log.calls("all-reduce") == 1
    assert log.bytes("all-reduce") == 24 and log.bytes("all-gather") == 24
    assert log.bytes() == 48
    assert [r[2] for r in log.records] == [(0,)] * 2
    log.reset()
    assert log.calls() == 0


def test_collectives_take_non_contiguous_tensors(one_rank_group):
    x = torch.arange(12, dtype=torch.float32).view(3, 4).t()
    np.testing.assert_array_equal(mesh.all_reduce_sum(x).numpy(),
                                  x.numpy())
    assert mesh.all_gather_rows(x)[0].is_contiguous()
