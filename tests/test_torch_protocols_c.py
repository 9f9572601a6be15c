"""The slice as a whole, Mix2FLD (see test_torch_protocols_a), and the
port's config refusals for what the slice does not run."""
import pytest

from repro_torch.channel import ChannelConfig
from repro_torch.core.protocols import FederatedConfig
from repro_torch.core.sampling import ChurnConfig
from test_torch_protocols_a import check_history, run_both


def test_mix2fld_run_matches_live_reference():
    want, got = run_both("mix2fld")
    check_history(want, got)
    assert got["seeds"]["hard_labels"] and got["seeds"]["n_pairs"] > 0


@pytest.mark.parametrize("make,kw", [
    (FederatedConfig, dict(shard_devices=True)),
    (FederatedConfig, dict(churn=ChurnConfig(p_active=0.5))),
    (FederatedConfig, dict(model="transformer")),
    (FederatedConfig, dict(model="cnn+transformer", protocol="fd")),
    (FederatedConfig, dict(model_partition=("cnn", "tf"), num_devices=2,
                           protocol="fd")),
    (ChannelConfig, dict(compute_mean_s=0.1))])
def test_config_refuses_what_the_slice_does_not_run(make, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make(**kw)


def test_config_validation_matches_reference():
    with pytest.raises(ValueError, match="unknown protocol"):
        FederatedConfig(protocol="nonsense")
    with pytest.raises(ValueError, match="n_seed"):
        FederatedConfig(n_seed=0)
    with pytest.raises(ValueError, match="lam"):
        FederatedConfig(lam=1.5)
    assert FederatedConfig(protocol="mix2fd").protocol == "mixfld"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ChannelConfig(compute_mean_s=0.1)
    with pytest.raises(TypeError, match="ChurnConfig"):
        FederatedConfig(churn=0.5)
