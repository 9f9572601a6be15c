"""Qwen3 14B — dense, qk-norm, GQA(40/8). [hf:Qwen/Qwen3-8B family]"""
from . import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-14b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
))
