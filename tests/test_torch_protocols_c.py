"""The slice as a whole, Mix2FLD (see test_torch_protocols_a), the
port's config refusals for what it does not run yet, and the churn and
straggler configs, which it runs (a round of each against the
reference's)."""
import numpy as np
import pytest
import torch

from repro_torch.channel import ChannelConfig
from repro_torch.core.protocols import FederatedConfig, FederatedTrainer
from repro_torch.core.sampling import ChurnConfig
from repro_torch.launch.service import FederatedService
from test_torch_protocols_a import check_history, run_both
from test_torch_reference import (GOLDEN_CFG, GOLDEN_P_UP_DBM, golden_data,
                                  load_reference,
                                  one_thread_per_module)  # noqa: F401


def test_mix2fld_run_matches_live_reference():
    want, got = run_both("mix2fld")
    check_history(want, got)
    assert got["seeds"]["hard_labels"] and got["seeds"]["n_pairs"] > 0


@pytest.mark.parametrize("make,kw", [
    (FederatedConfig, dict(shard_devices=True)),
    # the transformer classifier runs since A15-train; the mesh-sharded
    # device axis (A13) refuses it as it refuses every model
    (FederatedConfig, dict(model="transformer", shard_devices=True)),
    (FederatedConfig, dict(model="cnn+transformer", protocol="fd",
                           shard_devices=True)),
    (FederatedConfig, dict(model_partition=("cnn", "tf"), num_devices=2,
                           protocol="fd", shard_devices=True))])
def test_config_refuses_what_the_slice_does_not_run(make, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make(**kw)


@pytest.mark.parametrize("kw", [
    dict(model="transformer"),
    dict(model="cnn+transformer", protocol="fd"),
    dict(model_partition=("cnn", "tf"), num_devices=2, protocol="fd")])
def test_config_takes_the_transformer_classifier(kw):
    ref = load_reference().protocols
    want, got = ref.FederatedConfig(**kw), FederatedConfig(**kw)
    assert got.model == want.model
    assert got.model_partition == want.model_partition
    assert got.model_key() == want.model_key()


def test_config_validation_matches_reference():
    with pytest.raises(ValueError, match="unknown protocol"):
        FederatedConfig(protocol="nonsense")
    with pytest.raises(ValueError, match="n_seed"):
        FederatedConfig(n_seed=0)
    with pytest.raises(ValueError, match="lam"):
        FederatedConfig(lam=1.5)
    assert FederatedConfig(protocol="mix2fd").protocol == "mixfld"
    with pytest.raises(TypeError, match="ChurnConfig"):
        FederatedConfig(churn=0.5)


def _check_round(got, want):
    for k in ("round", "uplink_ok", "n_straggle", "n_active"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["acc"], want["acc"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["round_latency_s"],
                               want["round_latency_s"], rtol=1e-6)


def test_config_with_churn_builds_and_runs_the_references_round():
    """``FederatedConfig(churn=...)`` builds, and the service it drives
    trains the reference's churned cohort in its first round."""
    churn = dict(p_active=0.5, min_active=2, seed=4)
    ref = load_reference()
    want = ref.service.FederatedService(
        None, ref.protocols.FederatedConfig(
            protocol="mix2fld", churn=ref.sampling.ChurnConfig(**churn),
            **GOLDEN_CFG),
        ref.channel.ChannelConfig(num_devices=4, p_up_dbm=GOLDEN_P_UP_DBM),
    ).bind_data(*golden_data()).step()
    fc = FederatedConfig(protocol="mix2fld", churn=ChurnConfig(**churn),
                         **GOLDEN_CFG)
    assert fc.churn == ChurnConfig(**churn)
    got = FederatedService(
        None, fc, ChannelConfig(num_devices=4, p_up_dbm=GOLDEN_P_UP_DBM),
        device="cpu").bind_data(*golden_data()).step()
    assert got["n_active"] < 4
    np.testing.assert_array_equal(got["active"], want["active"])
    _check_round(got, want)


def test_channel_with_stragglers_builds_and_runs_the_references_round():
    """``ChannelConfig(compute_mean_s=0.1)`` builds, and a round under it
    equals the reference's, straggler count included."""
    ch = dict(num_devices=4, p_up_dbm=GOLDEN_P_UP_DBM, compute_mean_s=0.1,
              deadline_s=0.12)
    ref = load_reference()
    rtr = ref.protocols.FederatedTrainer(
        None, ref.protocols.FederatedConfig(protocol="fd", **GOLDEN_CFG),
        ref.channel.ChannelConfig(**ch))
    _, want = rtr.round_once(rtr.init_state(), *golden_data())
    tr = FederatedTrainer(None, FederatedConfig(protocol="fd", **GOLDEN_CFG),
                          ChannelConfig(**ch), device="cpu")
    dev_x, dev_y, tx, ty = golden_data()
    _, got = tr.round_once(tr.init_state(), torch.tensor(dev_x),
                           torch.tensor(dev_y).long(), torch.tensor(tx),
                           torch.tensor(ty).long())
    assert got["n_straggle"] > 0
    _check_round(got, want)
