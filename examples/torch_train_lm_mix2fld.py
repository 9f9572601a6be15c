"""End-to-end LM training on the PyTorch/CUDA port: Mix2FLD at
language-model scale.

Trains a reduced (default ~25M parameters; ``--preset 100m`` for the
~100M configuration) qwen2-style model across 2 simulated pods with the
full protocol loop: pod-local SGD steps with the KD-regularised loss,
periodic FD uplink (per-bucket average output tables, whose forward
runs the flash attention kernel), server output-to-model conversion,
FL downlink broadcast.

Runs on the GPU by default; ``--device cpu`` runs on the CPU:

  PYTHONPATH=src python examples/torch_train_lm_mix2fld.py --steps 60
  PYTHONPATH=src python examples/torch_train_lm_mix2fld.py --preset 100m \\
      --steps 300   # the ~100M / few-hundred-steps configuration
  PYTHONPATH=src python examples/torch_train_lm_mix2fld.py --steps 4 \\
      --sync-every 2 --device cpu

``main(argv)`` returns ``launch/train.py``'s ``run_lm`` result: the
pod-stacked parameters and the history.
"""
import sys

from repro_torch.launch import train


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    return train.main(["--mode", "lm"] + argv)


if __name__ == "__main__":
    main()
