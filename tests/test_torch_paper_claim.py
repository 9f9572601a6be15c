"""The paper's headline claim, asserted on the port (ROADMAP C2): the
training CLI's ``--mode paper --noniid`` (``repro_torch.launch.train.
run_paper``) at ``tests/test_system.py:17-36``'s config — 10 devices,
non-IID data, the asymmetric channel (23 dBm uplink, 40 dBm downlink),
K = K_s = 80, batch 32.  Mix2FLD keeps uploading in every one of its 4
rounds and passes accuracy 0.25; FL's uplink never gets a model through
in 2 rounds (Sec. IV).  That reference test is marked slow and cannot
run under the installed jax (ROADMAP C1); this one runs on the CPU.
"""
import types

from repro_torch.launch import train
from test_torch_reference import one_thread_per_module  # noqa: F401


def _args(protocol, rounds):
    return types.SimpleNamespace(
        protocol=protocol, devices=10, local_iters=80, rounds=rounds,
        noniid=True, symmetric=False, device="cpu")


def test_mix2fld_keeps_uploading_and_learns_where_fl_cannot(capsys):
    h = train.run_paper(_args("mix2fld", 4))
    assert len(h["uplink_ok"]) == 4
    assert all(n > 0 for n in h["uplink_ok"])  # FD uplink survives
    assert h["acc"][-1] > 0.25

    h_fl = train.run_paper(_args("fl", 2))
    assert len(h_fl["uplink_ok"]) == 2
    assert all(n == 0 for n in h_fl["uplink_ok"])
    assert "final acc=" in capsys.readouterr().out
