"""Data substrate: the synthetic digits task, its TaskSpec and the IID
partitioner."""
from .partition import partition_iid  # noqa: F401
from .pipeline import TaskSpec, parse_task  # noqa: F401
from .synthetic import synthetic_images  # noqa: F401
