"""Mix2FLD core of the port: losses, Mixup / inverse-Mixup, seed
collection, the eq. (5) conversion and the protocol round loop."""
from .mixup import (cycle_lams, find_label_cycles, inverse_mixup,  # noqa: F401
                    inverse_mixup_cycles, inverse_mixup_n,
                    inverse_mixup_ratios, make_mixup_batch, mixup_pairs,
                    pair_symmetric)
from .losses import cross_entropy, fd_loss, kd_regularizer  # noqa: F401
from .outputs import label_averaged_outputs  # noqa: F401
