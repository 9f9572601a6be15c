"""Qwen2-VL 72B — VLM backbone, M-RoPE, GQA(64/8). Vision tower is a stub:
``input_specs`` supplies precomputed patch embeddings. [arXiv:2409.12191]

All 80 layers (71,460,495,360 parameters, 143 GB in bf16) do not fit
one 80 GB card: :func:`card` is the config with its depth cut to
``CARD_LAYERS``, every width as published."""
import dataclasses

from . import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    mrope=True,
    qkv_bias=True,
    embed_input=True,    # patch/token embeddings provided by the stub frontend
    rope_theta=1e6,
    grad_accum=4,   # 64-seq microbatches at train_4k: fits 16 GB/chip HBM
))

# 8 of 80 layers: 8 x 877,684,736 + the 152,064 x 8,192 unembedding and
# the final norm = 8,267,194,368 parameters, ~15.4 GiB in bf16
CARD_LAYERS = 8


def card() -> ArchConfig:
    """The published widths at ``CARD_LAYERS`` of 80 layers."""
    return dataclasses.replace(CONFIG, num_layers=CARD_LAYERS)
