"""Batched LM serving driver: prefill a batch of prompts into a cache,
then decode greedily, on the dense and SSM architectures (qwen2-0.5b,
mamba2-370m; the smoke preset by default, ``--full`` for the published
widths).

Usage (on the GPU; ``--device cpu`` runs the plain kernel versions):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --batch 4 --prompt-len 64 --gen 32 [--full]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      [--full]

The federated classifier endpoint (``serve_classifier``) waits for the
service stack (ROADMAP A11).
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import rng
from ..configs import get_config
from ..data import synthetic_tokens
from ..device import resolve_device
from ..models.transformer import count_params, init_params
from .steps import make_decode_step, make_prefill_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(arch: str, batch: int, prompt_len: int, gen: int,
          smoke: bool = True, log=print, device=None):
    """Returns the generated tokens (batch, gen) int64.  Weights from
    PRNGKey(0) and prompts from PRNGKey(1), as in the reference."""
    device = resolve_device(device)
    if device.type == "cuda":
        # float32 matmuls in full float32, like the reference (the
        # smoke config's parity with the CPU depends on it)
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    params = init_params(cfg, rng.PRNGKey(0), device=device)
    log(f"arch={arch} params={count_params(params)/1e6:.2f}M "
        f"batch={batch} prompt={prompt_len} gen={gen}")

    total = prompt_len + gen
    prefill = make_prefill_step(cfg, total)
    decode = make_decode_step(cfg)
    prompts = synthetic_tokens(rng.PRNGKey(1), batch, prompt_len,
                               cfg.vocab_size, device=device)

    _sync(device)
    t0 = time.perf_counter()
    logits_last, cache = prefill(params, {"tokens": prompts})
    nxt = torch.argmax(logits_last, dim=-1)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    outs = [nxt]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        nxt, cache = decode(params, {"tokens": nxt[:, None], "cache": cache})
        outs.append(nxt)
    _sync(device)
    t_decode = time.perf_counter() - t0
    gen_tokens = torch.stack(outs, dim=1)
    log(f"prefill: {t_prefill*1e3:.1f} ms "
        f"({batch * prompt_len / max(t_prefill, 1e-9):.0f} tok/s)")
    log(f"decode : {t_decode*1e3:.1f} ms "
        f"({batch * (gen - 1) / max(t_decode, 1e-9):.1f} tok/s)")
    log(f"sample continuation (seq 0): {gen_tokens[0, :12].tolist()}")
    return gen_tokens


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-smoke) config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    serve(args.arch, args.batch, args.prompt_len, args.gen,
          smoke=not args.full, device=args.device)


if __name__ == "__main__":
    main()
