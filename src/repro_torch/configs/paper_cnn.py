"""The paper's own model: 3-layer CNN (2 conv + 1 FC), ~12.5k weights,
10-class MNIST-style 28x28 inputs.  N_mod in the paper is 12,544; the
exact layer shapes are unpublished — the reconstruction (conv 1->14,
conv 14->20, fc 980->10) lands at 12,490 weights.
"""
from . import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paper-cnn",
    family="cnn",
    source="Mix2FLD (this paper), Sec. IV",
    num_layers=3,
    d_model=28,          # image side
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=10,       # N_L = 10 labels
    attn_type="none",
    fd_buckets=10,       # exact per-label output vectors (no bucketing)
    param_dtype="float32",
))

# CNN-specific hyperparameters (used by repro_torch.models.cnn)
CONV_CHANNELS = (14, 20)
KERNEL = 3
POOL = 2
IMAGE_SIZE = 28
NUM_CLASSES = 10
