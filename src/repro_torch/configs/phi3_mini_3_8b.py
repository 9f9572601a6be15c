"""Phi-3-mini 3.8B — dense, RoPE + SwiGLU + GQA(32/32). [arXiv:2404.14219]"""
import dataclasses

from . import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    source="arXiv:2404.14219",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
))


def width96_smoke() -> ArchConfig:
    """The smoke preset at the published head shape: 4 heads of 96, as
    many KV heads (MHA).  Small enough for the CPU, its prefill runs flash
    attention at the full model's head dim."""
    return dataclasses.replace(CONFIG.smoke(), num_heads=4, num_kv_heads=4,
                               head_dim=96)
