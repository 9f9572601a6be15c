"""Batched LM serving driver: prefill a batch of prompts into a cache,
then decode greedily, on the token architectures (qwen2-0.5b, qwen3-14b,
phi3-mini-3.8b, h2o-danube-3-4b, qwen2-moe-a2.7b, deepseek-v2-236b,
whisper-medium, mamba2-370m, zamba2-2.7b; the smoke preset by default,
``--full`` for the published widths; deepseek-v2's 60 layers do not fit
one 80 GB card: on the GPU, serve a config of it with its depth cut,
``dataclasses.replace(CONFIG, num_layers=6)``).  whisper-medium's
decoder attends to a stub encoder output drawn from PRNGKey(2), passed
to the prefill and to every decode step, as in the reference.  The vlm
architecture (qwen2-vl-72b) takes embeddings, not tokens: as in the
reference, it serves through the prefill and decode steps with stub
embeddings (``chip_smoke.py`` phase 38), and this driver refuses it.

Usage (on the GPU; ``--device cpu`` runs the plain kernel versions):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --batch 4 --prompt-len 64 --gen 32 [--full]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
      --batch 4 --prompt-len 1024 [--full]
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch phi3-mini-3.8b [--full]
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch h2o-danube-3-4b --full --batch 2 --prompt-len 8192
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen2-moe-a2.7b [--full]
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-236b
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch whisper-medium [--full]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      [--full]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      [--full]

h2o-danube-3-4b's prompt of 8192 passes its window of 4096: its cache is
a 4096-slot ring and decode runs past the window.

Federated classifiers serve through the service's fixed-batch endpoint
(``launch/service.py`` ``InferenceEndpoint``) with ``--classifier`` (a
model registry name) and ``--task`` (the registry task that fixes the
input geometry):

  PYTHONPATH=src python -m repro_torch.launch.serve --classifier cnn \\
      --task digits --batch 16
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import rng
from ..configs import ArchConfig, get_config
from ..data import synthetic_tokens
from ..device import resolve_device
from ..models.layers import dtype_of
from ..models.transformer import count_params, init_params
from .steps import make_decode_step, make_prefill_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stub_encoder(cfg, batch: int, device) -> dict:
    """``{"enc_out": (batch, encoder_seq, d_model)}`` for a cross-attention
    config, the stub encoder's output frames (a normal from PRNGKey(2) in
    the parameters' dtype, as the reference's serve draws them); ``{}``
    for any other."""
    if not cfg.cross_attention:
        return {}
    return {"enc_out": rng.normal(
        rng.PRNGKey(2, resolve_device(device)),
        (batch, cfg.encoder_seq, cfg.d_model)).to(dtype_of(cfg))}


@torch.inference_mode()
def serve(arch: str | ArchConfig, batch: int, prompt_len: int, gen: int,
          smoke: bool = True, log=print, device=None, params=None):
    """Returns the generated tokens (batch, gen) int64.  Weights from
    PRNGKey(0) (or ``params``, a tree of the config on the device) and
    prompts from PRNGKey(1), as in the reference.  ``arch`` is a registry
    name (``smoke`` picks its preset) or a config, served as it is."""
    device = resolve_device(device)
    if device.type == "cuda":
        # float32 matmuls in full float32, like the reference (the
        # smoke config's parity with the CPU depends on it)
        torch.backends.cuda.matmul.allow_tf32 = False
    if isinstance(arch, ArchConfig):
        cfg, arch = arch, arch.name
    else:
        cfg = get_config(arch)
        if smoke:
            cfg = cfg.smoke()
    if cfg.embed_input:
        raise SystemExit(f"{arch}: serve demo uses token archs; "
                         "vlm/audio serve via the same decode_step with "
                         "stub embeddings (see dryrun decode shapes)")
    if params is None:
        params = init_params(cfg, rng.PRNGKey(0), device=device)
    log(f"arch={arch} params={count_params(params)/1e6:.2f}M "
        f"batch={batch} prompt={prompt_len} gen={gen}")

    total = prompt_len + gen
    prefill = make_prefill_step(cfg, total)
    decode = make_decode_step(cfg)
    prompts = synthetic_tokens(rng.PRNGKey(1), batch, prompt_len,
                               cfg.vocab_size, device=device)
    extra = stub_encoder(cfg, batch, device)

    _sync(device)
    t0 = time.perf_counter()
    logits_last, cache = prefill(params, {"tokens": prompts, **extra})
    nxt = torch.argmax(logits_last, dim=-1)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    outs = [nxt]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        nxt, cache = decode(params, {"tokens": nxt[:, None], "cache": cache,
                                     **extra})
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


def serve_classifier(model_name: str, task_name: str, batch: int,
                     requests: int = 40, log=print, device=None):
    """Single-shot classifier serving: the registry model at the task's
    geometry (weights from PRNGKey(0), requests from the task's data at
    PRNGKey(1)) behind the federated inference endpoint, one fixed batch
    shape with the last batch padded.  Returns the predicted labels."""
    from ..data.pipeline import parse_task
    from ..models.registry import build_model
    from .service import InferenceEndpoint

    device = resolve_device(device)
    task = parse_task(task_name)
    model = build_model(model_name, task.input_shape, task.num_classes)
    params = model.init(rng.PRNGKey(0, device))
    log(f"classifier={model_name} task={task.name} "
        f"input={task.input_shape} classes={task.num_classes} "
        f"params={model.num_params(params)/1e3:.1f}K batch={batch}")
    endpoint = InferenceEndpoint(model.apply, batch,
                                 input_shape=task.input_shape,
                                 device=device)
    x, _ = task.data(rng.PRNGKey(1), requests, device=device)
    endpoint.submit(x)
    _sync(device)
    t0 = time.perf_counter()
    preds = endpoint.flush(params)
    t_serve = time.perf_counter() - t0
    log(f"served {preds.shape[0]} requests in {endpoint.batches} "
        f"batches: {t_serve*1e3:.1f} ms "
        f"({preds.shape[0] / max(t_serve, 1e-9):.0f} req/s)")
    log(f"sample predictions: {preds[:12].tolist()}")
    return preds


def main(argv=None):
    """The command line; returns the generated tokens (or the
    classifier's predictions)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--classifier", default=None,
                    help="serve a federated classifier from the model "
                         "registry instead of a token arch")
    ap.add_argument("--task", default="digits",
                    help="registry task fixing the classifier's input "
                         "geometry (with --classifier)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-smoke) config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.classifier is not None:
        return serve_classifier(args.classifier, args.task, args.batch,
                                device=args.device)
    return serve(args.arch, args.batch, args.prompt_len, args.gen,
                 smoke=not args.full, device=args.device)


if __name__ == "__main__":
    main()
