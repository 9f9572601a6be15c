"""The cifar (32x32x3) and speech (32x40x1, 12 classes) tasks on the port
against the live reference: FD and Mix2FLD on each task's golden pool,
IID over 4 devices, at the golden config and tolerances (see
test_torch_protocols_a)."""
import pytest

from test_torch_protocols_a import check_history, run_both
from test_torch_reference import golden_data, one_thread_per_module  # noqa: F401


@pytest.mark.parametrize("task", ["cifar", "speech"])
@pytest.mark.parametrize("protocol", ["fd", "mix2fld"])
def test_task_run_matches_live_reference(task, protocol):
    want, got = run_both(protocol, golden_data(task=task), task=task)
    check_history(want, got)
