"""Mamba2 370M — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from . import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-370m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,              # no MLP: mamba2 blocks are mixer-only
    vocab_size=50280,
    attn_type="none",
    ssm_state=128,
    ssm_head_dim=64,     # d_inner 2048 -> 32 ssm heads
    ssm_expand=2,
))
