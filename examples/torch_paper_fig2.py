"""Fig. 2 on the PyTorch/CUDA port: FL vs FD vs FLD vs MixFLD vs Mix2FLD
learning curves under asymmetric and symmetric channels, IID and
non-IID, as one heterogeneous grid through the port's ``SweepRunner``.

The grid is ``benchmarks/bench_protocols.py``'s: the five protocols x
IID / non-IID x p_up 23 / 40 dBm (20 points, one program per protocol)
over Mix2FLD's Fig. 2 base (D 10, K 150, B 32, K_s 150, B_s 32, 8
rounds, seed 1) on the synthetic digits from PRNGKey(0).  ``--quick``
takes its reduced settings: K = K_s = 15, 2 rounds, D 5, 100 samples a
device, and p_up 15 dBm for the asymmetric points (at D 5, 23 dBm still
decodes the FL payload).  Every local step launches the fused distill
kernel, and each Mixup seed prep the Mixup kernel.

Runs on the GPU by default; ``--device cpu`` runs the kernels' plain
PyTorch versions on the CPU:

  PYTHONPATH=src python examples/torch_paper_fig2.py [--quick]
  PYTHONPATH=src python examples/torch_paper_fig2.py --quick --device cpu

The results go to ``build/examples/protocols_fig2.json`` (``--out``
names another directory).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from repro_torch import rng
from repro_torch.channel import ChannelConfig
from repro_torch.core.protocols import PROTOCOLS, FederatedConfig
from repro_torch.data import PartitionSpec, synthetic_images
from repro_torch.device import resolve_device
from repro_torch.models.cnn import CNN
from repro_torch.sweep import SweepRunner, make_grid

P_UP = {"asym": 23.0, "sym": 40.0}
QUICK = dict(local_iters=15, server_iters=15, max_rounds=2, num_devices=5,
             n_local=100)
QUICK_P_UP_ASYM = 15.0
RESULTS = Path(__file__).resolve().parents[1] / "build" / "examples"


def sample_pool(n_train: int, n_test: int = 1000, seed: int = 0,
                device=None):
    """(pool_x, pool_y, test_x, test_y): the digits from PRNGKey(seed),
    the first ``n_train`` the pool each point's PartitionSpec splits."""
    x, y = synthetic_images(rng.PRNGKey(seed), n_train + n_test,
                            device=device)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def fig2_grid(local_iters=150, server_iters=150, max_rounds=8,
              num_devices=10, n_local=500, quick=False):
    """(grid, p_up, n_train): the Fig. 2 grid of the protocols x IID /
    non-IID x the two p_up values, and the pool size it splits."""
    p_up = dict(P_UP)
    if quick:
        local_iters, server_iters, max_rounds, num_devices, n_local = (
            QUICK[k] for k in ("local_iters", "server_iters", "max_rounds",
                               "num_devices", "n_local"))
        p_up["asym"] = QUICK_P_UP_ASYM
    base = FederatedConfig(
        protocol="mix2fld", num_devices=num_devices,
        local_iters=local_iters, local_batch=32,
        server_iters=server_iters, server_batch=32,
        max_rounds=max_rounds, seed=1)
    grid = make_grid(base, ChannelConfig(num_devices=num_devices),
                     PartitionSpec(n_local=n_local, seed=0),
                     protocol=PROTOCOLS, partition=("iid", "noniid"),
                     p_up_dbm=tuple(p_up.values()))
    return grid, p_up, num_devices * n_local


def run(local_iters=150, server_iters=150, max_rounds=8, num_devices=10,
        n_local=500, quick=False, device=None, out=RESULTS, log=print):
    """The grid through one ``SweepRunner`` on ``device`` (default: the
    GPU).  Returns {"<protocol>_<partition>_<asym|sym>": {acc,
    cum_time_s, uplink_ok, converged_round, wall_s, programs}} and writes
    it to ``out``/protocols_fig2.json."""
    device = resolve_device(device)
    grid, p_up, n_train = fig2_grid(local_iters, server_iters, max_rounds,
                                    num_devices, n_local, quick)
    pool = sample_pool(n_train, device=device)
    t0 = time.time()
    runner = SweepRunner(CNN(), grid, *pool, device=device)
    res = runner.run()
    wall = round(time.time() - t0, 1)
    chan_of = {v: k for k, v in p_up.items()}
    results = {}
    for g, label in enumerate(grid.labels()):
        h = res.history(g)
        key = (f"{label['protocol']}_{label['partition']}"
               f"_{chan_of[label['p_up_dbm']]}")
        results[key] = {
            "acc": h["acc"],
            "cum_time_s": h["cum_time_s"],
            "uplink_ok": h["uplink_ok"],
            "converged_round": h["converged_round"],
            "wall_s": wall,
            "programs": runner.programs,
        }
        log(f"{key}: final_acc={h['acc'][-1]:.3f} "
            f"up_ok={h['uplink_ok']}")
    log(f"heterogeneous sweep: {grid.size} points, "
        f"{runner.programs} programs, "
        f"seed prep {runner.seed_prep_stats}, wall={wall}s")
    Path(out).mkdir(parents=True, exist_ok=True)
    with open(Path(out) / "protocols_fig2.json", "w") as f:
        json.dump(results, f, indent=1, default=float)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=str(RESULTS),
                    help="directory of protocols_fig2.json")
    # the grid's sizes when not --quick (which sets its own)
    ap.add_argument("--local-iters", type=int, default=150)
    ap.add_argument("--server-iters", type=int, default=150)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--devices", type=int, default=10)
    ap.add_argument("--n-local", type=int, default=500)
    args = ap.parse_args(argv)
    res = run(args.local_iters, args.server_iters, args.rounds, args.devices,
              args.n_local, quick=args.quick, device=args.device,
              out=args.out)
    print("\n=== final accuracies ===")
    for k, v in sorted(res.items()):
        print(f"{k:28s} acc={v['acc'][-1]:.3f} "
              f"rounds_converged={v['converged_round']} "
              f"uplink_ok={v['uplink_ok']}")
    return res


if __name__ == "__main__":
    main()
