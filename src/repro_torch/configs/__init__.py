"""Architecture configs of the port: a copy of the reference's
``ArchConfig`` (every field, property and ``smoke()``), its input shapes
and its name registry.

The registry holds every architecture of the reference: ``qwen2-0.5b``,
``qwen3-14b``, ``phi3-mini-3.8b``, ``h2o-danube-3-4b``,
``qwen2-moe-a2.7b``, ``deepseek-v2-236b``, ``qwen2-vl-72b``,
``whisper-medium``, ``mamba2-370m`` and ``zamba2-2.7b`` (the LM serve
and train paths) and ``paper-cnn`` (the paper's own model, whose layer
constants live in ``configs/paper_cnn.py``).  The dry-run
``input_specs`` wait for ``launch/dryrun.py``, which comes with the LM
sharding rules of ``launch/sharding.py`` (the roofline is ported).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

# ---------------------------------------------------------------------------
# Input shapes (assigned; fixed across architectures)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    """Complete architecture description.

    ``d_ff`` follows the assignment sheet: for MoE archs it is the routed
    expert intermediate size (also exposed as ``moe_d_ff``).
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | cnn
    source: str  # citation from the assignment sheet
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- attention flavour ---------------------------------------------
    attn_type: str = "gqa"  # gqa | mla | none
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # None = full attention
    rope_theta: float = 1e4
    mrope: bool = False  # qwen2-vl multimodal rope (3 interleaved sections)
    pos_emb: str = "rope"  # rope | learned (whisper)
    max_position: int = 1 << 20

    # --- MLA (deepseek-v2) ----------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0  # defaults to head_dim

    # --- MoE --------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512  # tokens per dispatch group (GShard-style)
    router_aux_weight: float = 0.01

    # --- SSM (mamba2 / zamba2) -------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # --- hybrid (zamba2) ---------------------------------------------------
    attn_every: int = 0  # apply the shared attention block every k layers

    # --- encoder-decoder (whisper) ----------------------------------------
    cross_attention: bool = False
    encoder_seq: int = 1500

    # --- frontend stub (vlm / audio) ---------------------------------------
    embed_input: bool = False  # inputs are precomputed embeddings

    # --- misc ---------------------------------------------------------------
    mlp_act: str = "silu"  # silu (SwiGLU) | gelu (plain MLP, whisper)
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- Mix2FLD / FD adaptation -------------------------------------------
    fd_buckets: int = 256  # vocab hash-buckets for per-label output vectors
    kd_beta: float = 0.01  # paper's beta

    # --- numerics / training -------------------------------------------------
    param_dtype: str = "bfloat16"
    kv_quant: bool = False  # int8 KV cache (+per-position/head scales)
    learning_rate: float = 0.01  # paper's eta
    grad_accum: int = 1          # microbatches per train step

    # ------------------------------------------------------------------
    @property
    def v_head(self) -> int:
        return self.v_head_dim or self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def subquadratic(self) -> bool:
        """True if long_500k decode is admissible (bounded per-token cost)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def supports_shape(self, shape_name: str) -> bool:
        shp = INPUT_SHAPES[shape_name]
        if shp.name == "long_500k" and not self.subquadratic:
            return False  # dense full-attention: documented skip
        return True

    # ------------------------------------------------------------------
    def smoke(self) -> "ArchConfig":
        """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        head_dim = 32
        num_heads = max(2, min(4, self.num_heads))
        num_kv = max(1, min(num_heads, self.num_kv_heads, 2))
        kw = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 4 * d_model) or self.d_ff,
            vocab_size=min(self.vocab_size, 512),
            max_position=4096,
            param_dtype="float32",
            fd_buckets=64,
            moe_group_size=64,
        )
        if self.is_moe:
            kw.update(
                num_experts=4,
                top_k=min(2, self.top_k),
                num_shared_experts=min(1, self.num_shared_experts),
                moe_d_ff=2 * d_model,
                d_ff=2 * d_model,
                # dropless in smoke configs: capacity >= group size makes
                # full-vs-incremental parity exact (capacity drops are
                # grouping-dependent by construction)
                capacity_factor=float(4 // max(1, min(2, self.top_k))),
            )
        if self.attn_type == "mla":
            kw.update(kv_lora_rank=64, q_lora_rank=96, rope_head_dim=16,
                      v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
        if self.attn_every:
            kw.update(attn_every=2)
        if self.sliding_window:
            kw.update(sliding_window=128)
        if self.cross_attention:
            kw.update(encoder_seq=24)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name.endswith("-smoke"):
        return _REGISTRY[name.removesuffix("-smoke")].smoke()
    return _REGISTRY[name]


def list_archs(assigned_only: bool = False) -> list[str]:
    _ensure_loaded()
    names = sorted(_REGISTRY)
    if assigned_only:
        names = [n for n in names if n != "paper-cnn"]
    return names


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (deepseek_v2_236b, h2o_danube3_4b,  # noqa: F401
                   mamba2_370m, paper_cnn, phi3_mini_3_8b, qwen2_0_5b,
                   qwen2_moe_a2_7b, qwen2_vl_72b, qwen3_14b,
                   whisper_medium, zamba2_2_7b)
