"""DeepSeek-V2 236B — MLA + 160-expert MoE (2 shared, top-6). [arXiv:2405.04434]"""
import dataclasses

from . import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,   # MLA: logical heads; cache is the 512-d latent
    head_dim=128,
    d_ff=1536,          # routed expert intermediate (assignment sheet)
    vocab_size=102400,
    attn_type="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    rope_theta=1e4,
    grad_accum=4,   # 32-seq microbatches at train_4k: fits 16 GB/chip HBM
))


def width192_smoke() -> ArchConfig:
    """The smoke preset at MLA's published head shape: 4 heads, a nope
    head dim of 128 and a rope head dim of 64 (q and k 192 wide), values
    128 wide.  Small enough for the CPU, its prefill runs flash attention
    at the full model's (d, dv) = (192, 128)."""
    return dataclasses.replace(CONFIG.smoke(), num_heads=4, head_dim=128,
                               rope_head_dim=64, v_head_dim=128)


def routing_smoke() -> ArchConfig:
    """The smoke preset at the published routing: d_model 5120, 160
    routed experts, top 6, 2 shared, capacity factor 1.25 in groups of
    512 (24 places an expert, so tokens drop).  The experts are 64 wide
    (the routing does not read their width), so that the CPU draws it in
    seconds."""
    return dataclasses.replace(
        CONFIG.smoke(), name=CONFIG.name + "-routing-smoke", d_model=5120,
        num_experts=160, top_k=6, num_shared_experts=2, moe_d_ff=64,
        d_ff=64, capacity_factor=1.25, moe_group_size=512)
