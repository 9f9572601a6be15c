"""Whisper-medium — encoder-decoder; conv/mel frontend is a stub supplying
encoder-output frame embeddings. We model the decoder transformer (self-attn +
cross-attn) with learned positions, LayerNorm and GELU. [arXiv:2212.04356]

At the published widths it fits one card whole: ~1.58 B parameters, of
which ~1.07 B are the 2**20 x 1024 learned position table that
``max_position`` asks for."""
from . import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    cross_attention=True,
    encoder_seq=1500,
    embed_input=False,   # decoder consumes tokens; encoder output is the stub
    pos_emb="learned",
    mlp_act="gelu",
    norm_type="layernorm",
    max_position=1 << 20,  # shape-only exercise beyond the real 448 cap
))
