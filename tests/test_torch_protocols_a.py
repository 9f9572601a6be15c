"""The slice as a whole: FederatedTrainer.run of the port against the
reference run live in the same test, at the reference's golden config
(tests/test_protocols.py), one protocol per test case.

Tolerances: loss and acc to 1e-4 (acc to 1e-4 means the same count of
correct test samples), latency rtol 1e-6, uplink_ok and converged_round
equal.  The protocols are split over three files so that parallel
workers share the reference runs.  The recorded ``GOLDEN`` dict of the
reference came from an older jax whose PRNG stream differed, so the port
is held to the reference as it runs under the installed jax.
"""
import numpy as np
import pytest

from repro_torch.channel import ChannelConfig
from repro_torch.core.protocols import FederatedConfig, FederatedTrainer
from repro_torch.models import CNN
from test_torch_reference import (GOLDEN_CFG, GOLDEN_P_UP_DBM, golden_data,
                                  load_reference)


def run_both(protocol):
    ref = load_reference()
    dev_x, dev_y, tx, ty = golden_data()
    want = ref.protocols.FederatedTrainer(
        ref.cnn.CNN(), ref.protocols.FederatedConfig(protocol=protocol,
                                                     **GOLDEN_CFG),
        ref.channel.ChannelConfig(num_devices=4, p_up_dbm=GOLDEN_P_UP_DBM),
    ).run(dev_x, dev_y, tx, ty)
    got = FederatedTrainer(
        CNN(), FederatedConfig(protocol=protocol, **GOLDEN_CFG),
        ChannelConfig(num_devices=4, p_up_dbm=GOLDEN_P_UP_DBM),
        device="cpu").run(dev_x, dev_y, tx, ty)
    return want, got


def check_history(want, got):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["acc"], want["acc"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["round_latency_s"],
                               want["round_latency_s"], rtol=1e-6)
    assert got["uplink_ok"] == want["uplink_ok"]
    assert got["converged_round"] == want["converged_round"]
    assert got["seeds"] == want["seeds"]
    for k in ("uplink_bits_first", "uplink_bits", "downlink_bits"):
        assert got[k] == want[k]


@pytest.mark.parametrize("protocol", ["fl", "fd"])
def test_run_matches_live_reference(protocol):
    check_history(*run_both(protocol))
