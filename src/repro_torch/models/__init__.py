"""Model stack of the port: the paper CNN, the classifier MLP and the
transformer classifier behind the model registry, and the dense, SSM
(Mamba2) and hybrid stacks of the LM serve and train paths (``layers``,
``rope``, ``attention``, ``mamba2``, ``kvcache``, ``mlp``,
``transformer``).  The MoE/MLA/vlm/audio families wait for later slices
(ROADMAP A15-arch)."""
from .cnn import CNN, from_jax_params, to_jax_params  # noqa: F401
from .mlp import MLPClassifier  # noqa: F401
from .transformer import TransformerClassifier  # noqa: F401
from .registry import ModelSpec, build_model, parse_model  # noqa: F401
