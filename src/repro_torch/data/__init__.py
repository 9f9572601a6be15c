"""Data substrate: the synthetic digits task, its TaskSpec and the IID
partitioner, and the synthetic token streams of the LM serve path."""
from .partition import partition_iid  # noqa: F401
from .pipeline import TaskSpec, parse_task  # noqa: F401
from .synthetic import synthetic_images, synthetic_tokens  # noqa: F401
