"""The round program (``core/program.py``) and the round state's helpers,
at the reference tests' golden size.

A link outcome is a function of ``(plan, key)`` alone, so the
double-buffered program (``pipeline_depth > 1``) may dispatch draws
rounds ahead of their collection without changing a bit: depth 2 equals
depth 1 exactly, with the straggler stage on.  Each depth-2 history is
also held to the live reference's run (loss and acc atol 1e-4, latency
rtol 1e-6, uplink outcomes and straggler counts equal).
"""
import numpy as np
import pytest
import torch

from repro_torch.channel import ChannelConfig
from repro_torch.core.program import LoopRoundProgram, ProgramOptions
from repro_torch.core.protocols import FederatedConfig, FederatedTrainer
from repro_torch.core.sampling import ChurnConfig
from repro_torch.core.state import RoundState
from repro_torch.launch.service import FederatedService
from test_torch_reference import (GOLDEN_CFG, GOLDEN_P_UP_DBM, golden_data,
                                  load_reference,
                                  one_thread_per_module)  # noqa: F401


#: history keys equal between schedules (compute_s and cum_time_s are
#: host clock readings)
_KEYS = ("acc", "loss", "round_latency_s", "uplink_ok", "converged_round")
STRAG = dict(num_devices=4, p_up_dbm=GOLDEN_P_UP_DBM, compute_mean_s=0.05,
             deadline_s=0.15)


def _trainer(protocol, **ch):
    return FederatedTrainer(
        None, FederatedConfig(protocol=protocol, **GOLDEN_CFG),
        ChannelConfig(**(ch or dict(num_devices=4,
                                    p_up_dbm=GOLDEN_P_UP_DBM))),
        device="cpu")


def _tensors():
    dev_x, dev_y, tx, ty = golden_data()
    return (torch.tensor(dev_x), torch.tensor(dev_y).long(),
            torch.tensor(tx), torch.tensor(ty).long())


def _equal(h1, h2):
    for k in _KEYS:
        assert h1[k] == h2[k], k


@pytest.mark.parametrize("protocol", ["fl", "fd", "mix2fld"])
def test_depth2_bitwise_equals_serial_and_the_reference(protocol):
    data = golden_data()
    tr = _trainer(protocol, **STRAG)
    h1 = tr.run(*data, options=ProgramOptions(pipeline_depth=1))
    h2 = tr.run(*data, options=ProgramOptions(pipeline_depth=2))
    _equal(h1, h2)
    ref = load_reference()
    rtr = ref.protocols.FederatedTrainer(
        None, ref.protocols.FederatedConfig(protocol=protocol, **GOLDEN_CFG),
        ref.channel.ChannelConfig(**STRAG))
    want = rtr.run(*data)
    np.testing.assert_allclose(h2["loss"], want["loss"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(h2["acc"], want["acc"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(h2["round_latency_s"],
                               want["round_latency_s"], rtol=1e-6)
    assert h2["uplink_ok"] == want["uplink_ok"]
    assert h2["converged_round"] == want["converged_round"]
    assert h2["pipeline"] == {**want["pipeline"], "dispatched": 4,
                              "abandoned": 1, "pipeline_depth": 2}


def test_round_records_count_the_stragglers():
    """An aggressive deadline drops devices from ``up_ok`` and the record
    reports how many straggled (the reference's round_once records)."""
    ch = dict(num_devices=4, p_up_dbm=GOLDEN_P_UP_DBM, compute_mean_s=1.0,
              deadline_s=0.7)
    dev_x, dev_y, tx, ty = _tensors()
    tr = _trainer("fd", **ch)
    ref = load_reference()
    rtr = ref.protocols.FederatedTrainer(
        None, ref.protocols.FederatedConfig(protocol="fd", **GOLDEN_CFG),
        ref.channel.ChannelConfig(**ch))
    state, rstate = tr.init_state(), rtr.init_state()
    total = 0
    for _ in range(3):
        state, rec = tr.round_once(state, dev_x, dev_y, tx, ty)
        rstate, want = rtr.round_once(rstate, *golden_data())
        assert rec["n_straggle"] == want["n_straggle"]
        assert rec["uplink_ok"] == want["uplink_ok"] <= 4 - rec["n_straggle"]
        np.testing.assert_allclose(rec["loss"], want["loss"], atol=1e-4)
        total += rec["n_straggle"]
    assert total > 0


def test_default_run_is_depth1():
    data = golden_data()
    tr = _trainer("fd")
    h0 = tr.run(*data)
    assert h0["pipeline"]["pipeline_depth"] == 1
    assert h0["pipeline"]["dispatched"] == h0["pipeline"]["collected"] == 3
    _equal(h0, tr.run(*data, options=ProgramOptions(pipeline_depth=2)))


def test_dispatch_window_stats():
    """Depth d keeps at most d draws in flight: R rounds with one plan
    dispatch R + d - 1 draws, collect R and abandon d - 1."""
    data = golden_data()
    tr = _trainer("fd")
    for depth in (1, 2, 3):
        stats = tr.run(*data,
                       options=ProgramOptions(pipeline_depth=depth))[
                           "pipeline"]
        assert stats == {"dispatched": 3 + depth - 1, "collected": 3,
                         "abandoned": depth - 1, "pipeline_depth": depth}


def test_plan_change_invalidates_prefetch():
    """A held draw whose plan is not the round's is dropped, never
    collected: the round draws anew under its own plan."""
    dev_x, dev_y, tx, ty = _tensors()
    tr = _trainer("fd")
    prog = LoopRoundProgram(tr, ProgramOptions(pipeline_depth=2))
    prog.bind(dev_x=dev_x, dev_y=dev_y, test_x=tx, test_y=ty)
    state = tr.init_state()
    state, _ = prog.step(state)          # prefetches round 2's draw
    plan3 = tr.link_plan(state.g_params, n_links=3)
    cohort = state.replace(
        dev_params={k: {n: t[:3] for n, t in v.items()}
                    for k, v in state.dev_params.items()},
        dev_gout=state.dev_gout[:3])
    state3, rec = prog.step(cohort, {"dev_x": dev_x[:3],
                                     "dev_y": dev_y[:3], "plan": plan3})
    assert prog.collected == 1
    assert rec["uplink_ok"] <= 3 and rec["n_active"] == 3
    # the round drew under its own plan and key, as the serial path does
    _, serial = tr.round_once(cohort, dev_x[:3], dev_y[:3], tx, ty,
                              plan=plan3)
    assert rec["round_latency_s"] == serial["round_latency_s"]
    assert rec["uplink_ok"] == serial["uplink_ok"]
    assert prog.finalize()["abandoned"] == 1


def test_service_depth2_matches_serial(tmp_path):
    """The service under churn gives the same records at depth 1 and 2
    (stale prefetches invalidated by the per-round plan), and a depth-2
    restore drops the window and continues identically."""
    data = golden_data()
    fc = FederatedConfig(protocol="fd", **GOLDEN_CFG)
    ch = ChannelConfig(**STRAG)
    churn = ChurnConfig(p_active=0.75, min_active=2, seed=1)

    def run(depth, ckpt_dir=None):
        svc = FederatedService(
            None, fc, ch, churn=churn, ckpt_dir=ckpt_dir,
            options=ProgramOptions(pipeline_depth=depth), device="cpu")
        svc.bind_data(*data)
        return svc, svc.run_rounds(4)

    keys = ("round", "acc", "loss", "round_latency_s", "uplink_ok",
            "n_straggle", "n_active")
    _, r1 = run(1)
    svc2, r2 = run(2, ckpt_dir=str(tmp_path))
    assert len({r["n_active"] for r in r2}) > 1
    for a, b in zip(r1, r2):
        assert [a[k] for k in keys] == [b[k] for k in keys]
        np.testing.assert_array_equal(a["active"], b["active"])
    stats = svc2._program.finalize()
    assert stats["collected"] < stats["dispatched"]   # invalidations

    svc3 = FederatedService(None, fc, ch, churn=churn,
                            ckpt_dir=str(tmp_path),
                            options=ProgramOptions(pipeline_depth=2),
                            device="cpu")
    svc3.bind_data(*data)
    assert svc3.restore(step=2) == 2
    for a, b in zip(r2[2:], svc3.run_rounds(2)):
        assert [a[k] for k in keys] == [b[k] for k in keys]


def test_program_options_validation():
    ref = load_reference().program
    for mod in (ref, None):
        make = ref.ProgramOptions if mod else ProgramOptions
        with pytest.raises(ValueError, match="pipeline_depth"):
            make(pipeline_depth=0)
        with pytest.raises(ValueError, match="mesh_shape"):
            make(mesh_shape=(2,))
        with pytest.raises(ValueError, match="mesh_shape"):
            make(mesh_shape=(0, 4))
        assert make(mesh_shape=[2, 4]).mesh_shape == (2, 4)


def test_loop_program_ignores_the_mesh_shape():
    data = golden_data()
    tr = _trainer("fd")
    _equal(tr.run(*data),
           tr.run(*data, options=ProgramOptions(mesh_shape=(2, 2))))


def test_round_state_helpers_match_the_reference():
    ref = load_reference().state.RoundState
    m = {"round": 3, "key": 7, "converged": 2, "cum_time_s": 1.5}
    want, got = ref.from_mapping(m), RoundState.from_mapping(m)
    for f in ("round", "key", "converged_round", "cum_time_s", "prev"):
        assert getattr(got, f) == getattr(want, f)
    assert RoundState.from_mapping(got) is got
    new = got.replace(round=4, converged=None)
    assert (new.round, new.converged_round, got.round) == (4, None, 3)
    for make in (ref.from_mapping, RoundState.from_mapping):
        with pytest.raises(ValueError, match="bogus"):
            make({"round": 1, "bogus": 0})
