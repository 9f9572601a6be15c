"""Fig. 2's non-IID setting on the port against the live reference: the
five protocols on the paper's non-IID partition of the golden pool (2
rare labels of 2 samples and 8 labels of 37 per device), at the golden
config and tolerances (see test_torch_protocols_a).  Split over two
files for the parallel workers."""
import pytest

from test_torch_protocols_a import check_history, run_both
from test_torch_reference import golden_data, one_thread_per_module  # noqa: F401


@pytest.mark.parametrize("protocol", ["fl", "fd", "fld"])
def test_noniid_run_matches_live_reference(protocol):
    want, got = run_both(protocol, golden_data("noniid"))
    check_history(want, got)
