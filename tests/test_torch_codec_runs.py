"""The uplink codecs in a run on the port against the live reference, at
the golden config and tolerances (see test_torch_protocols_a): FL with
8-bit stochastic quantization and with delta coding, and Mix2FLD with
the Gaussian DP codec, whose epsilon ledger matches within rtol 1e-12."""
import pytest

from test_torch_protocols_a import check_history, run_both
from test_torch_reference import one_thread_per_module  # noqa: F401


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("protocol,codec", [
    ("fl", "quantize8"), ("fl", "delta"), ("mix2fld", "dp_gaussian1.0")])
def test_codec_run_matches_live_reference(protocol, codec):
    want, got = run_both(protocol, codec=codec)
    check_history(want, got)
    if codec.startswith("dp"):
        assert len(got["dp_epsilon"]) == 3 and got["dp"]["rounds"] == 3
