"""Zamba2 2.7B — hybrid Mamba2 backbone + shared attention block. [arXiv:2411.15242]"""
import dataclasses

from . import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,         # 2560 / 32
    d_ff=10240,          # shared block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,     # d_inner 5120 -> 80 ssm heads
    ssm_expand=2,
    attn_every=6,        # shared attention block applied every 6 mamba layers
    sliding_window=4096, # windowed shared attention => long_500k admissible
    grad_accum=2,        # SSD decay tensors at train_4k: fits 16 GB/chip
))


def width80_smoke() -> ArchConfig:
    """The smoke preset at the published head shapes: two super-blocks
    sharing one attention block, head dim 80, (P, N) = (64, 64).  Small
    enough for the CPU, its prefill runs both kernels at the full
    model's per-head shapes."""
    return dataclasses.replace(CONFIG.smoke(), num_layers=4, num_heads=4,
                               num_kv_heads=4, head_dim=80, ssm_head_dim=64,
                               ssm_state=64)
