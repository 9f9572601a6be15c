"""Cohorts on the port against the live reference, at the golden config
and tolerances (see test_torch_protocols_a): the MLP, a mixed CNN + MLP
cohort (one captured local step per architecture group), an explicit
``model_partition`` whose first group is the MLP, and client sampling
(a cohort of 2 of the 4 devices each round)."""
import pytest

from test_torch_protocols_a import check_history, run_both
from test_torch_reference import one_thread_per_module  # noqa: F401


@pytest.mark.parametrize("kw", [
    dict(model="mlp"), dict(model="cnn+mlp"),
    dict(model="cnn", model_partition=("mlp", "cnn", "cnn", "mlp"))],
    ids=["mlp", "cnn+mlp", "model_partition"])
def test_model_run_matches_live_reference(kw):
    protocol = "fld" if "model_partition" in kw else "mix2fld"
    check_history(*run_both(protocol, **kw))


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("protocol", ["fl", "mix2fld"])
def test_sampled_run_matches_live_reference(protocol):
    want, got = run_both(protocol, sample_ratio=0.5)
    check_history(want, got)
    assert got["cohort_size"] == 2 and got["uplink_ok"] == [2, 2, 2]
