"""Model stack of the port: the paper CNN.  The model registry, the MLP
and the transformer/SSM stack wait for later slices."""
from .cnn import CNN, from_jax_params, to_jax_params  # noqa: F401
