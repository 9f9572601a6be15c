"""Model stack of the port: the paper CNN, the classifier MLP and the
transformer classifier behind the model registry, and every LM family of
the reference for the serve and train paths (``layers``, ``rope``,
``attention``, ``moe``, ``mamba2``, ``kvcache``, ``mlp``,
``transformer``): dense (GQA, qk-norm, windows), MoE, MLA, vlm (M-RoPE,
embedding inputs), audio (cross-attention), SSM (Mamba2) and hybrid, and
the int8 KV cache."""
from .cnn import CNN, from_jax_params, to_jax_params  # noqa: F401
from .mlp import MLPClassifier  # noqa: F401
from .transformer import (Transformer, TransformerClassifier,  # noqa: F401
                          active_params, count_params, init_params)
from .registry import ModelSpec, build_model, parse_model  # noqa: F401
