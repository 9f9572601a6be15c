"""Batched serving on the PyTorch/CUDA port: prefill + KV-cache greedy
decode on any ported token architecture (the smoke preset by default,
``--full`` for the published widths).  The prefill runs the flash
attention kernel once per attention layer (24 at qwen2-0.5b) and the
SSD scan kernel once per mamba layer (``--arch mamba2-370m``).

Runs on the GPU by default; ``--device cpu`` runs the kernels' plain
PyTorch versions on the CPU:

  PYTHONPATH=src python examples/torch_serve_batched.py --arch qwen3-14b
  PYTHONPATH=src python examples/torch_serve_batched.py --full --batch 4 \\
      --prompt-len 1024 --gen 32
  PYTHONPATH=src python examples/torch_serve_batched.py --arch mamba2-370m \\
      --device cpu

``main(argv)`` returns the generated tokens (batch, gen).
"""
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
