"""The paper's own model: 3-layer CNN (2 conv + 1 FC), ~12.5k weights,
10-class MNIST-style 28x28 inputs.  N_mod in the paper is 12,544; the
exact layer shapes are unpublished — the reconstruction (conv 1->14,
conv 14->20, fc 980->10) lands at 12,490 weights.
"""

CONV_CHANNELS = (14, 20)
KERNEL = 3
POOL = 2
IMAGE_SIZE = 28
NUM_CLASSES = 10
