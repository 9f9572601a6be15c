"""H2O-Danube3 4B — llama/mistral mix with sliding-window attention. [arXiv:2401.16818]"""
import dataclasses

from . import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    source="arXiv:2401.16818",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,        # 3840 / 32
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,  # SWA => long_500k admissible with bounded cache
))


def width120_smoke() -> ArchConfig:
    """The smoke preset at the published head shapes: 4 heads of 120
    reading one KV head (the full model's 4 query heads a KV head), the
    smoke window of 128.  Small enough for the CPU, its prefill runs flash
    attention at the full model's head dim with a window that masks once
    the prompt passes 128."""
    return dataclasses.replace(CONFIG.smoke(), num_heads=4, num_kv_heads=1,
                               head_dim=120)
