"""Data substrate: the synthetic digits, cifar and speech tasks and their
TaskSpecs, the IID, non-IID and Dirichlet partitioners, and the
synthetic token streams of the LM serve and train paths, and the
training CLI's paper dataset (``protocol_dataset``)."""
from .partition import (PARTITION_SCHEMES, PartitionSpec,  # noqa: F401
                        partition_dirichlet, partition_iid, partition_noniid,
                        protocol_dataset)
from .pipeline import TaskSpec, device_batches, parse_task  # noqa: F401
from .synthetic import (synthetic_audio, synthetic_images,  # noqa: F401
                        synthetic_rgb_images, synthetic_tokens)
