"""Quickstart on the PyTorch/CUDA port: one Mix2FLD run, end to end.

The same run as ``examples/quickstart.py``: 5 devices x 500 synthetic
digits from PRNGKey(0), Mix2FLD with K = 60 local steps of batch 32,
K_s = 60 conversion steps, 2 rounds, over the paper's asymmetric
channel (23 dBm up, 40 dBm down).  Algorithm 1:

  1. devices mix up seed samples (eq. 6, the Mixup kernel) and upload
     them with their per-label average outputs (eq. 2) over the fading
     uplink; every local step is one launch of the fused distill kernel,
  2. the server inversely mixes the seeds (eq. 7 / Prop. 1, the Mixup
     kernel), builds G_out and runs the output-to-model conversion
     (eq. 5),
  3. devices download the converted global model (FL-style downlink).

Runs on the GPU by default; ``--device cpu`` runs the kernels' plain
PyTorch versions on the CPU:

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

``main(device=None, **overrides)`` returns the history; ``overrides``
replace fields of the run's ``FederatedConfig`` (``--local-iters``,
``--server-iters`` and ``--rounds`` on the command line).
"""
from __future__ import annotations

import argparse

from repro_torch import rng
from repro_torch.channel import ChannelConfig
from repro_torch.core.protocols import FederatedConfig, FederatedTrainer
from repro_torch.data import partition_iid, synthetic_images
from repro_torch.device import resolve_device
from repro_torch.models.cnn import CNN

CONFIG = dict(protocol="mix2fld", num_devices=5, local_iters=60,
              local_batch=32, server_iters=60, max_rounds=2)
PER_DEVICE, N_TEST, NUM_CLASSES = 500, 1000, 10


def main(device=None, log=print, **overrides):
    """The quickstart run on ``device`` (default: the GPU); returns the
    history of ``FederatedTrainer.run``."""
    device = resolve_device(device)
    fc = FederatedConfig(**dict(CONFIG, **overrides))
    n_train = fc.num_devices * PER_DEVICE
    x, y = synthetic_images(rng.PRNGKey(0), n_train + N_TEST, device=device)
    dev_x, dev_y = partition_iid(x[:n_train], y[:n_train], fc.num_devices,
                                 PER_DEVICE, NUM_CLASSES)
    ch = ChannelConfig(num_devices=fc.num_devices)  # asymmetric 23/40 dBm
    trainer = FederatedTrainer(CNN(), fc, ch, device=device)
    h = trainer.run(dev_x, dev_y, x[n_train:], y[n_train:], log=log)

    meta = h["seeds"]
    log(f"\nuploaded mixed-up seeds : {meta['n_uploaded']}")
    log(f"inversely mixed-up seeds: {meta['n_train']} "
        f"(augmented, hard labels={meta['hard_labels']})")
    log(f"label-cycle histogram   : {meta['cycle_hist']}")
    log(f"accuracy after {fc.max_rounds} rounds: {h['acc'][-1]:.3f}")
    return h


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--local-iters", type=int, default=CONFIG["local_iters"])
    ap.add_argument("--server-iters", type=int,
                    default=CONFIG["server_iters"])
    ap.add_argument("--rounds", type=int, default=CONFIG["max_rounds"])
    args = ap.parse_args(argv)
    return main(args.device, local_iters=args.local_iters,
                server_iters=args.server_iters, max_rounds=args.rounds)


if __name__ == "__main__":
    cli()
