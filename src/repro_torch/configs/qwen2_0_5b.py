"""Qwen2 0.5B — dense, GQA(14/2), QKV bias. [arXiv:2407.10671]"""
from . import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
))
