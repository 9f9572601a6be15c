"""Hand-written CUDA kernels for the reference's Pallas kernels, each with
its plain PyTorch version beside it.

  mixup_kernel    — two-way Mixup / inverse-Mixup batch transform (eq. 6/7)
  distill_loss    — per-sample (phi, psi) of eq. 3 and its backward, and
                    the fused forward-only loss
  flash_attention — causal flash-attention forward (LM prefill)
  ssd_scan        — the Mamba2 SSD chunked scan (SSM prefill), with the
                    final state the cache-building prefill needs
  ops             — the reference's public wrappers over all of them

``runtime`` builds the CUDA sources (``csrc/``) with nvcc at first use and
holds the dispatch rule: a CUDA tensor launches the kernel (or raises), a
CPU tensor takes the plain version.
"""
