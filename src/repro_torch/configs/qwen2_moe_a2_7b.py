"""Qwen2-MoE A2.7B — 4 shared + 60 routed experts, top-4. [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
import dataclasses

from . import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,           # routed expert intermediate (assignment sheet)
    vocab_size=151936,
    num_experts=60,
    num_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
    grad_accum=2,   # MoE dispatch tensors at train_4k: fits 16 GB/chip
))


def routing_smoke() -> ArchConfig:
    """The smoke preset at the published routing: d_model 2048, 60 routed
    experts, top 4, 4 shared, capacity factor 1.25 in groups of 512 (so
    tokens drop), 4 heads of 128.  The experts are 64 wide (the routing
    does not read their width), so that the CPU draws it in seconds."""
    return dataclasses.replace(
        CONFIG.smoke(), name=CONFIG.name + "-routing-smoke", d_model=2048, num_heads=4, num_kv_heads=4,
        head_dim=128, num_experts=60, top_k=4, num_shared_experts=4,
        moe_d_ff=64, d_ff=64, capacity_factor=1.25, moe_group_size=512)
