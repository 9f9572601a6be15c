"""Model stack of the port: the paper CNN and the classifier MLP behind
the model registry, and the dense and SSM (Mamba2) stacks of the LM serve
path (``layers``, ``rope``, ``attention``, ``mamba2``, ``kvcache``,
``mlp``, ``transformer``).  The transformer classifier and the
MoE/MLA/hybrid families wait for later slices (ROADMAP A15)."""
from .cnn import CNN, from_jax_params, to_jax_params  # noqa: F401
from .mlp import MLPClassifier  # noqa: F401
from .registry import ModelSpec, build_model, parse_model  # noqa: F401
