"""Fig. 2's non-IID setting, the Mixup protocols (see test_torch_fig2_a),
and Mix2FLD on a Dirichlet partition (alpha 0.5)."""
import pytest

from test_torch_protocols_a import check_history, run_both
from test_torch_reference import golden_data, one_thread_per_module  # noqa: F401


@pytest.mark.parametrize("protocol", ["mixfld", "mix2fld"])
def test_noniid_run_matches_live_reference(protocol):
    want, got = run_both(protocol, golden_data("noniid"))
    check_history(want, got)
    if protocol == "mix2fld":
        # the rare labels' seeds pair and cycle as the reference's
        assert got["seeds"]["hard_labels"] and got["seeds"]["n_pairs"] > 0


def test_dirichlet_run_matches_live_reference():
    want, got = run_both("mix2fld", golden_data("dirichlet", alpha=0.5))
    check_history(want, got)
