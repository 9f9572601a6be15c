"""The slice as a whole, FLD and MixFLD (see test_torch_protocols_a)."""
import pytest

from test_torch_protocols_a import check_history, run_both


@pytest.mark.parametrize("protocol", ["fld", "mixfld"])
def test_run_matches_live_reference(protocol):
    check_history(*run_both(protocol))
