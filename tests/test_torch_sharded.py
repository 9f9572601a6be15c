"""The sharded round loop (``FederatedConfig.shard_devices``) on gloo
ranks on the CPU, held to the reference's own contract
(``tests/test_protocols.py:273-308``): one shard equals the port's
vmapped run bit for bit; 2 and 4 shards are within 1e-4 of the live
reference's vmapped run (acc, loss; ``last_dev_gout`` 1e-5; latency,
``uplink_ok``, ``converged_round`` and the seed exchange equal).  The
reference's own sharded path cannot run more than one shard under the
installed jax (ROADMAP C4).  Also: every rank's replicated state equal
bit for bit at every round's end, 2 ranks bit for bit their emulation
in one process, a rank beyond the mesh changes
nothing, the sampled trainer's mesh spans the cohort, and the
collectives a round.  Each world size starts its ranks once
(``torch_ranks.spawn``) and runs all its configs there."""
import functools

import numpy as np
import pytest

from repro_torch.channel import ChannelConfig
from repro_torch.core.protocols import FederatedConfig, FederatedTrainer
from repro_torch.core.sampling import SamplerConfig
from repro_torch.data import partition_iid
from repro_torch.models import CNN
from test_torch_reference import (GOLDEN_CFG, GOLDEN_P_UP_DBM, golden_data,
                                  golden_pool, load_reference,
                                  one_thread_per_module)  # noqa: F401
from repro_torch.launch.ranks import emulated_shards, record_rounds
from torch_ranks import one_rank_group, start, trainer_runs  # noqa: F401

PROTOCOLS = ("fl", "fd", "mix2fld")
CH = dict(num_devices=4, p_up_dbm=GOLDEN_P_UP_DBM)
# the sampled trainer: 8 devices, half a round, so each of 2 ranks
# trains 2 of the cohort's 4 rows
SAMPLED = dict(GOLDEN_CFG, num_devices=8, protocol="mix2fld",
               sampler=SamplerConfig(sample_ratio=0.5))
SAMPLED_CH = dict(num_devices=8, p_up_dbm=GOLDEN_P_UP_DBM)


@functools.lru_cache(maxsize=None)
def sampled_data():
    x, y = golden_pool()
    dev_x, dev_y = partition_iid(x[:1200], y[:1200], 8, 150, 10, seed=0)
    return np.asarray(dev_x), np.asarray(dev_y), x[1200:], y[1200:]


@functools.lru_cache(maxsize=None)
def reference_run(protocol):
    """The live reference's vmapped run at the golden config."""
    ref = load_reference()
    tr = ref.protocols.FederatedTrainer(
        None, ref.protocols.FederatedConfig(protocol=protocol, **GOLDEN_CFG),
        ref.channel.ChannelConfig(**CH))
    h = tr.run(*golden_data())
    return h, np.asarray(tr.last_dev_gout)


@functools.lru_cache(maxsize=None)
def reference_sampled_run():
    """The live reference's vmapped run of ``SAMPLED``."""
    ref = load_reference()
    s = SAMPLED["sampler"]
    fc = dict(SAMPLED, sampler=ref.sampling.SamplerConfig(
        s.sample_ratio, s.min_active, s.seed))
    tr = ref.protocols.FederatedTrainer(
        None, ref.protocols.FederatedConfig(**fc),
        ref.channel.ChannelConfig(**SAMPLED_CH))
    h = tr.run(*sampled_data())
    return h, np.asarray(tr.last_dev_gout)


def port_run(fc_kw, ch_kw, data):
    tr = FederatedTrainer(None, FederatedConfig(**fc_kw),
                          ChannelConfig(**ch_kw), device="cpu")
    h = tr.run(*data)
    return h, tr.last_dev_gout.numpy(), tr


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """``ranks(world)``: every rank's results of the world's configs.
    The three worlds start together, before the module's first test,
    and run while the parent runs the vmapped runs and the reference."""
    started = {}
    for world in (2, 3, 4):
        runs = [(dict(GOLDEN_CFG, protocol=p), CH, golden_data())
                for p in (PROTOCOLS if world != 3 else ("mix2fld",))]
        if world == 2:
            runs.append((SAMPLED, SAMPLED_CH, sampled_data()))
        started[world] = start(trainer_runs, world,
                               tmp_path_factory.mktemp(f"w{world}"), runs)
    return lambda world: started[world].results()


def check_against(want, want_gout, got, atol=1e-4):
    np.testing.assert_allclose(got["history"]["acc"], want["acc"], rtol=0,
                               atol=atol)
    np.testing.assert_allclose(got["history"]["loss"], want["loss"], rtol=0,
                               atol=atol)
    assert got["history"]["round_latency_s"] == list(want["round_latency_s"])
    assert got["history"]["uplink_ok"] == list(want["uplink_ok"])
    assert got["history"]["converged_round"] == want["converged_round"]
    np.testing.assert_allclose(got["last_dev_gout"], want_gout, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_one_shard_equals_vmapped_bit_for_bit(protocol, one_rank_group):
    """In a plain process the mesh has one rank: every collective is the
    identity, so the history is the vmapped run's bit for bit (the
    reference's ``test_sharded_round_loop_matches_vmapped`` asks 1e-4)."""
    fc = dict(GOLDEN_CFG, protocol=protocol)
    h_v, g_v, tr_v = port_run(fc, CH, golden_data())
    h_s, g_s, tr_s = port_run(dict(fc, shard_devices=True), CH,
                              golden_data())
    assert tr_v.mesh is None and tuple(tr_s.mesh.shape) == (1,)
    for k in ("acc", "loss", "round_latency_s", "uplink_ok",
              "converged_round", "seeds"):
        assert h_s[k] == h_v[k], k
    np.testing.assert_array_equal(g_s, g_v)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_sharded_matches_live_reference(world, protocol, ranks):
    for p in PROTOCOLS:       # the reference runs while the ranks work
        reference_run(p)
    want, want_gout = reference_run(protocol)
    got = ranks(world)[0][PROTOCOLS.index(protocol)]
    assert got["mesh"] == (world,)
    assert got["step_rows"] == [4 // world]   # the rank's rows, captured
    check_against(want, want_gout, got)
    assert got["history"]["seeds"] == want["seeds"]


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_two_ranks_equal_their_emulation_bit_for_bit(protocol, ranks):
    """The vmapped run with the 2 ranks' step shape and partial sums
    emulated in one process (``emulated_shards``, code of its own) is
    what the ranks compute, bit for bit: history, last tables and every
    round's global model and tables."""
    tr = FederatedTrainer(None, FederatedConfig(protocol=protocol,
                                                **GOLDEN_CFG),
                          ChannelConfig(**CH), device="cpu")
    rounds = record_rounds(tr)
    with emulated_shards(tr, 2):
        want = tr.run(*golden_data())
    for out in ranks(2):
        got = out[PROTOCOLS.index(protocol)]
        for k, v in got["history"].items():
            assert v == want[k], k
        np.testing.assert_array_equal(got["last_dev_gout"],
                                      tr.last_dev_gout.numpy())
        assert len(got["rounds"]) == len(rounds) == 3
        for a, b in zip(got["rounds"], rounds):
            np.testing.assert_array_equal(a["g_params"], b["g_params"])
            np.testing.assert_array_equal(a["dev_gout"], b["dev_gout"])


@pytest.mark.parametrize("world", [2, 4])
def test_replicas_equal_at_every_round(world, ranks):
    """What every rank holds whole — the global model and the tables —
    is the same on every rank at every round's end, bit for bit."""
    out = ranks(world)
    for i in range(len(out[0])):
        for r in range(1, world):
            assert out[r][i]["history"] == out[0][i]["history"]
            for a, b in zip(out[0][i]["rounds"], out[r][i]["rounds"]):
                np.testing.assert_array_equal(a["g_params"], b["g_params"])
                np.testing.assert_array_equal(a["dev_gout"], b["dev_gout"])


def test_ranks_beyond_the_mesh_add_nothing(ranks):
    """3 ranks with D 4: the mesh takes the 2 that divide it, rank 2
    holds no rows and adds zeros, so the run is the 2-rank run bit for
    bit."""
    three, two = ranks(3), ranks(2)
    got, want = three[0][0], two[0][PROTOCOLS.index("mix2fld")]
    assert got["mesh"] == (2,) and got["step_rows"] == [2]
    assert three[2][0]["step_rows"] == []      # rank 2 never trained
    assert got["history"] == want["history"]
    np.testing.assert_array_equal(got["last_dev_gout"], want["last_dev_gout"])
    for r in (1, 2):
        np.testing.assert_array_equal(three[r][0]["rounds"][-1]["g_params"],
                                      got["rounds"][-1]["g_params"])


def test_sampled_trainer_mesh_spans_the_cohort(ranks):
    """``sample_ratio`` 0.5: each round gathers the cohort off the pool,
    then splits its 4 rows over the 2 ranks; the history is the port's
    and the live reference's vmapped runs' within the multichip
    bounds."""
    got = ranks(2)[0][-1]
    assert got["mesh"] == (2,) and got["step_rows"] == [2]
    want, want_gout, _ = port_run(SAMPLED, SAMPLED_CH, sampled_data())
    check_against(want, want_gout, got)
    want, want_gout = reference_sampled_run()
    check_against(want, want_gout, got)
    assert got["history"]["seeds"] == want["seeds"]


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_collectives_a_round(protocol, ranks):
    """One all-gather of the trained rows and, when an uplink decodes,
    one all-reduce for the aggregation: their bytes from the shapes."""
    got = ranks(2)[0][PROTOCOLS.index(protocol)]
    C, D = 10, 4
    n_params = CNN().num_params(CNN().init(
        __import__("repro_torch").rng.PRNGKey(0, "cpu")))
    row = (n_params + C * C + C + 1) * 4
    reduce = (1 + n_params) * 4 if protocol == "fl" else (C * C + C) * 4
    recs = got["records"]
    gathers = [r for r in recs if r[0] == "all-gather"]
    reduces = [r for r in recs if r[0] == "all-reduce"]
    assert len(gathers) == 3 and all(b == D * row for _, b, _ in gathers)
    assert len(reduces) == sum(1 for u in got["history"]["uplink_ok"] if u)
    assert all(b == reduce for _, b, _ in reduces)
    assert {r[2] for r in recs} == {(0, 1)}
