"""Training entry point (the reference's ``repro.launch.train``).

Two modes:

* ``--mode paper``: the letter's own experiment — federated CNN training
  over simulated wireless devices with any of fl/fd/fld/mixfld/mix2fld.

* ``--mode lm``: Mix2FLD at LM scale — pods (pod-stacked parameters, one
  pod after another on the one device) run local SGD steps with the
  KD-regularised loss, and sync through the FD uplink + output-to-model
  conversion + FL downlink (``launch/steps.py``), training one of the
  ported architectures (reduced preset by default).

Both run on the GPU unless ``--device cpu`` is given.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --mode paper \\
      --protocol mix2fld [--noniid] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \\
      --arch qwen2-0.5b --preset 25m --steps 50 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import checkpoint as ckpt
from .. import rng
from ..channel import ChannelConfig
from ..configs import get_config
from ..core.protocols import FederatedConfig, FederatedTrainer
from ..data import protocol_dataset, synthetic_tokens
from ..device import resolve_device
from ..kernels import runtime
from ..models.cnn import CNN
from ..models.transformer import count_params, init_params
from .steps import (make_favg_step, make_fd_sync_step, make_local_train_step,
                    pod, tree_map)


def _device(args):
    device = resolve_device(getattr(args, "device", None))
    if device.type == "cuda":
        # float32 matmuls in full float32, like the reference (the
        # float32 presets' parity with the CPU depends on it)
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def run_paper(args):
    device = _device(args)
    dev = protocol_dataset(num_devices=args.devices, iid=not args.noniid,
                           device=device)
    ch = ChannelConfig(num_devices=args.devices,
                       p_up_dbm=40.0 if args.symmetric else 23.0)
    fc = FederatedConfig(protocol=args.protocol, num_devices=args.devices,
                         local_iters=args.local_iters, local_batch=32,
                         server_iters=args.local_iters,
                         max_rounds=args.rounds)
    h = FederatedTrainer(CNN(), fc, ch, device=device).run(*dev, log=print)
    print(f"final acc={h['acc'][-1]:.3f} "
          f"converged_round={h['converged_round']} "
          f"cum_time={h['cum_time_s'][-1]:.1f}s")
    return h


def _preset(cfg, preset: str):
    if preset == "full":
        return cfg
    if preset == "100m":
        return dataclasses.replace(
            cfg, num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32000, param_dtype="float32",
            fd_buckets=64, max_position=4096)
    # 25m: CPU-friendly end-to-end demo
    return dataclasses.replace(
        cfg, num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
        head_dim=64, d_ff=1536, vocab_size=8192, param_dtype="float32",
        fd_buckets=64, max_position=2048,
        num_experts=min(cfg.num_experts, 8) if cfg.is_moe else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        moe_d_ff=1536 if cfg.is_moe else 0)


def tiny_preset(cfg):
    """The reference suite's tiny LM preset (``tests/test_drivers.py``):
    2 layers at d_model 128 and a 512-token vocab, in float32."""
    return dataclasses.replace(
        cfg, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, param_dtype="float32",
        fd_buckets=32, max_position=1024, num_experts=0,
        num_shared_experts=0, top_k=0, moe_d_ff=0)


def _timed(device, rec, fn, *args):
    """``fn(*args)``; appends its ms (host clock, ending in a
    synchronize of the device) and the kernel launches it made to
    ``rec["ms"]`` and ``rec["launches"]``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = runtime.launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec["ms"].append((time.perf_counter() - t0) * 1e3)
    rec["launches"].append({k: v - before[k] for k, v in
                            runtime.launch_counts().items()
                            if v != before[k]})
    return out


def run_lm(args, cfg=None):
    """Returns (the pod-stacked parameters after ``args.steps`` steps,
    the history).  ``cfg``: an ``ArchConfig`` in place of ``args.arch``
    at ``args.preset``.  Weights from PRNGKey(0), data from
    ``fold_in(key, 1)`` and each step's batch rows from ``fold_in(key,
    100 + step)``, as in the reference.

    The history holds each step's per-pod losses (``loss``), and the ms
    and kernel launches of each call of the local step (``local``), of
    the per-pod output tables (``favg``) and of the conversion
    (``conv``)."""
    device = _device(args)
    cfg = cfg or _preset(get_config(args.arch), args.preset)
    n_pods = args.pods
    key = rng.PRNGKey(0, device)
    params = init_params(cfg, key, device=device)
    print(f"arch={cfg.name} preset={args.preset} "
          f"params={count_params(params)/1e6:.1f}M pods={n_pods}")

    pod_params = tree_map(
        lambda p: p[None].expand((n_pods,) + p.shape).clone(), params)
    del params
    # the server's own model state (Alg. 1: w_s persists across rounds),
    # kept pod-stacked-but-consistent so conversion runs pod-locally.
    # The steps update out of place, so sharing the stack is safe.
    server_stack = pod_params
    local_step = make_local_train_step(cfg, n_pods)
    favg_one = make_favg_step(cfg)

    def favg_step(pp, batch):   # the reference's vmap over pods
        return torch.stack([favg_one(pod(pp, i), pod(batch, i))
                            for i in range(n_pods)])

    fd_sync = make_fd_sync_step(cfg, n_pods, ks_iters=args.ks_iters)

    B, S = args.batch, args.seq
    data = synthetic_tokens(rng.fold_in(key, 1), n_pods * B * 8, S + 1,
                            cfg.vocab_size, device=device)
    data = data.reshape(n_pods, B * 8, S + 1)
    seed_batch = {"tokens": data[0, :B, :]}  # inverse-mixed seeds stand-in
    nb = cfg.fd_buckets
    gout = torch.full((nb, nb), 1.0 / nb, device=device)
    rows = torch.arange(n_pods, device=device)[:, None]

    hist = {"loss": []}
    hist.update({k: {"ms": [], "launches": []}
                 for k in ("local", "favg", "conv")})
    t0 = time.time()
    for step in range(args.steps):
        k = rng.fold_in(key, 100 + step)
        idx = rng.randint(k, (n_pods, B), 0, data.shape[1])
        batch_tokens = data[rows, idx][..., :S]
        batch = {"tokens": batch_tokens,
                 "gout": gout.expand((n_pods,) + gout.shape)}
        pod_params, metrics = _timed(device, hist["local"], local_step,
                                     pod_params, batch)
        hist["loss"].append(metrics["loss"].tolist())
        if (step + 1) % args.sync_every == 0:
            # Mix2FLD sync: thin uplink (per-pod favg), pod-local server
            # conversion from the consistent w_s, replicated-compute
            # downlink (devices replace their params with G_mod)
            favg = _timed(device, hist["favg"], favg_step, pod_params,
                          {"tokens": batch_tokens})
            server_stack, gout = _timed(device, hist["conv"], fd_sync,
                                        server_stack, favg, seed_batch)
            pod_params = server_stack
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = sum(hist["loss"][-1]) / n_pods
            print(f"step {step:4d} loss={loss:.4f} "
                  f"({(time.time()-t0)/(step+1):.2f}s/step)")
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, pod(pod_params, 0))
        print(f"checkpoint -> {args.ckpt_dir}")
    return pod_params, hist


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("paper", "lm"), default="paper")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs on the CPU")
    # paper mode
    ap.add_argument("--protocol", default="mix2fld")
    ap.add_argument("--devices", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--local-iters", type=int, default=150)
    ap.add_argument("--noniid", action="store_true")
    ap.add_argument("--symmetric", action="store_true")
    # lm mode
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--preset", choices=("25m", "100m", "full"),
                    default="25m")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--sync-every", type=int, default=10)
    ap.add_argument("--ks-iters", type=int, default=4)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--ckpt-dir", default="")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.mode == "paper":
        return run_paper(args)
    return run_lm(args)


if __name__ == "__main__":
    main()
