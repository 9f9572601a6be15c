"""The protocol-sweep engine: a hyperparameter grid as one program per
group of structurally equal points (``sweep/engine.py``), with the grid
and its axes (``sweep/axes.py``) and the result frames
(``sweep/results.py``)."""
from .axes import (ALL_SWEEPABLE, CH_SWEEPABLE, FED_SWEEPABLE,  # noqa: F401
                   GROUP_SWEEPABLE, PART_SWEEPABLE, SweepGrid, make_grid)
from .engine import (SweepRunner, engine_stats, make_task_data,  # noqa: F401
                     run_pointwise, run_sweep)
from .results import SweepResult  # noqa: F401
