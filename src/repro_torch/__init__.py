"""PyTorch/CUDA port of the Mix2FLD reproduction.

A second package beside the JAX reference ``repro``: the same module
paths and names, PyTorch idiom inside, and hand-written CUDA kernels
(``csrc/``) for the reference's Pallas kernels.  It imports neither jax
nor anything of ``repro``.  Entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""
