"""The slice as a whole, FLD and MixFLD (see test_torch_protocols_a)."""
import pytest

from test_torch_protocols_a import check_history, run_both
from test_torch_reference import one_thread_per_module  # noqa: F401


@pytest.mark.parametrize("protocol", ["fld", "mixfld"])
def test_run_matches_live_reference(protocol):
    check_history(*run_both(protocol))
