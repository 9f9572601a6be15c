"""Model stack of the port: the paper CNN, and the dense and SSM (Mamba2)
stacks of the LM serve path (``layers``, ``rope``, ``attention``,
``mamba2``, ``kvcache``, ``mlp``, ``transformer``).  The model registry,
the classifier MLP and the MoE/MLA/hybrid families wait for later
slices (ROADMAP A10, A15)."""
from .cnn import CNN, from_jax_params, to_jax_params  # noqa: F401
