"""The continuous federated service: train round after round while
devices come and go, survive a kill, and answer inference requests
between rounds.

``FederatedTrainer.run`` trains a fixed number of rounds and exits; this
module drives the same round (:meth:`FederatedTrainer.round_once`,
through a ``core/program.py`` :class:`LoopRoundProgram`) as a
long-running service:

* **Churn.**  The active cohort of round ``p`` is a pure function of
  the seeds and ``p`` (``ChurnConfig.active_devices``, its own stream of
  ``core/sampling.py``), so a resumed run draws the cohorts the
  uninterrupted run would have, with no generator state to save.  The
  cohort's device state is gathered off the pool before the round and
  scattered back (``index_copy``) after it; each cohort size has its own
  link plan and its own captured local step.
* **Straggler timeouts** (``ChannelConfig.compute_mean_s`` /
  ``deadline_s``): devices past the deadline are dropped from the
  aggregation set like uplink outages (``channel/pipeline.py``).
* **Checkpoint and restore.**  Every ``ckpt_every`` rounds the state
  (run key, global and per-device parameters, ``gout``/``dev_gout``, the
  convergence reference, the round-1 seed set) goes through the
  crash-safe ``checkpoint`` package, with the host scalars (round,
  cumulative time, converged round, the DP accountant's position, the
  history) in its JSON ``meta``.  Every draw of a round derives from
  ``fold_in(key, p)``, and both are in the checkpoint, so a restored
  service continues the same stream bit for bit.  On the GPU that also
  needs kernels whose results do not vary from run to run: cuDNN's
  default backward algorithms for the grouped convolutions do (their
  sums are not ordered), so a round on CUDA runs with cuDNN's
  deterministic algorithms, and the local and conversion steps captured
  in it keep them.
* **Inference.**  :class:`InferenceEndpoint` answers requests against
  the current global model at one fixed batch shape, padding the last
  batch, on the service's device.

With churn and stragglers off, the records equal ``run``'s history.

CLI smoke (checkpoints, one served batch, and with ``--verify-resume`` a
restore of the halfway checkpoint whose tail must equal the first run's)::

    PYTHONPATH=src python -m repro_torch.launch.service --rounds 4 \\
        --verify-resume [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional

import numpy as np
import torch

from .. import checkpoint, rng
from ..channel import ChannelConfig
from ..core.privacy import GaussianAccountant
from ..core.program import LoopRoundProgram, ProgramOptions
from ..core.protocols import FederatedConfig, FederatedTrainer
from ..core.sampling import ChurnConfig
from ..core.seed_prep import summarize_seeds
from ..core.state import RoundState
from ..device import deterministic_cudnn, resolve_device

__all__ = ["ChurnConfig", "FederatedService", "InferenceEndpoint"]

#: Keys of one round's JSON-ready history record (the ``link`` arrays
#: stay out of the checkpoint meta).
_RECORD_KEYS = ("round", "acc", "loss", "round_latency_s", "compute_s",
                "cum_time_s", "uplink_ok", "n_straggle")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class InferenceEndpoint:
    """Fixed-batch inference over the current global model.

    ``submit`` queues request rows (numpy arrays or tensors, first axis
    the requests); ``flush`` answers every queued request, in submission
    order, in batches of ``batch_size`` (the last one padded with zero
    rows, whose answers are dropped), so the model always sees one
    shape.  Predictions run under ``torch.inference_mode()`` on
    ``device`` (the GPU unless the caller asks for the CPU).
    ``input_shape`` pins the shape of one request: a request batch of
    another shape is refused at ``submit``.
    """

    def __init__(self, apply_fn, batch_size: int = 16,
                 input_shape: Optional[tuple] = None, device=None):
        self.batch_size = batch_size
        self.input_shape = tuple(input_shape) if input_shape else None
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full float32, like the reference (cuDNN defaults to TF32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self._queue: list = []
        self.served = 0
        self.batches = 0

        def predict(params, x):
            with torch.inference_mode():
                return apply_fn(params, x).argmax(-1)

        self._predict = predict

    def submit(self, x) -> int:
        """Queue a request batch ``(n, ...)``; returns n."""
        if torch.is_tensor(x):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        if self.input_shape is not None and \
                tuple(x.shape[1:]) != self.input_shape:
            raise ValueError(
                f"endpoint serves a model built for input shape "
                f"{self.input_shape} but got a request batch of shape "
                f"{tuple(x.shape[1:])}")
        self._queue.extend(x)
        return x.shape[0]

    @property
    def pending(self) -> int:
        return len(self._queue)

    def flush(self, g_params) -> np.ndarray:
        """Answer every pending request against ``g_params``; returns the
        predicted labels in submission order.

        If a batch fails, no answer has left this call, so the whole
        flushed queue goes back ahead of anything submitted meanwhile
        before the exception propagates: the next flush answers every
        request, in order."""
        if not self._queue:
            return np.zeros((0,), np.int64)
        B = self.batch_size
        queue, self._queue = self._queue, []
        try:
            out = []
            for i in range(0, len(queue), B):
                chunk = np.stack(queue[i:i + B])
                n = chunk.shape[0]
                if n < B:
                    chunk = np.concatenate(
                        [chunk, np.zeros((B - n,) + chunk.shape[1:],
                                         chunk.dtype)])
                x = torch.as_tensor(chunk, dtype=torch.float32,
                                    device=self.device)
                out.append(self._predict(g_params, x)[:n])
                self.batches += 1
            preds = torch.cat(out).cpu().numpy()
        except BaseException:
            self._queue[:0] = queue
            raise
        self.served += preds.shape[0]
        return preds


class FederatedService:
    """Crash-safe continuous round driver over a device pool.

    ``bind_data`` attaches the whole population's shards ``(P, n_local,
    ...)`` and the test set; each :meth:`step` trains the round's churned
    cohort and scatters its device state back into the pool;
    :meth:`run_rounds` drives N of them, checkpointing every
    ``ckpt_every`` rounds into ``ckpt_dir`` (keeping the newest
    ``keep``); :meth:`restore` resumes from a checkpoint.  ``device``:
    the GPU by default, ``"cpu"`` to run on the CPU.
    """

    def __init__(self, model, fc: FederatedConfig,
                 ch: Optional[ChannelConfig] = None, *,
                 churn: Optional[ChurnConfig] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 1,
                 keep: Optional[int] = None, serve_batch: int = 16,
                 options: Optional[ProgramOptions] = None, device=None):
        if fc.model_partition is not None:
            raise ValueError(
                "FederatedService drives homogeneous cohorts: churn "
                "gathers/scatters one (P, ...) device stack, which a "
                "mixed-architecture cohort's per-architecture stacks "
                "don't fit; run mixed cohorts through FederatedTrainer")
        self.trainer = FederatedTrainer(model, fc, ch, device=device)
        self.fc = self.trainer.fc
        self.device = self.trainer.device
        # an explicit churn wins, then the config's own
        self.churn = churn or self.fc.churn or ChurnConfig()
        self.options = options or ProgramOptions()
        self._program = LoopRoundProgram(self.trainer, self.options)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.endpoint = InferenceEndpoint(
            self.trainer.model.apply, serve_batch,
            input_shape=self.fc.task_spec().input_shape, device=self.device)
        spec = self.fc.codec_spec()
        # churn and client sampling compose: round_once samples within
        # the churned cohort
        q = self.churn.p_active * self.fc.sample_ratio
        self._acct = (GaussianAccountant(spec.dp_sigma, spec.dp_delta,
                                         sample_ratio=q)
                      if spec.name == "dp_gaussian" else None)
        self.state = self.trainer.init_state()
        self.history: list[dict] = []
        self._data = None
        self._seed_meta = None  # summarize_seeds of the round-1 set

    def bind_data(self, pool_x, pool_y, test_x, test_y):
        """Attach the device pool and the test set (numpy arrays or
        tensors; they move to the service's device and stay out of the
        checkpoints)."""
        tr = self.trainer
        pool_x, test_x = (tr._tensor(a, torch.float32)
                          for a in (pool_x, test_x))
        pool_y, test_y = (tr._tensor(a, torch.int64)
                          for a in (pool_y, test_y))
        if pool_x.shape[0] != self.fc.num_devices:
            raise ValueError(
                f"pool has {pool_x.shape[0]} devices but the config "
                f"says num_devices={self.fc.num_devices}")
        self._data = (pool_x, pool_y, test_x, test_y)
        return self

    def step(self, log=None) -> dict:
        """One round over the churned cohort; returns the round record
        with ``n_active`` and ``active`` (pool indices of the devices
        that trained)."""
        if self._data is None:
            raise RuntimeError("call bind_data(...) before step()")
        pool_x, pool_y, test_x, test_y = self._data
        state = RoundState.from_mapping(self.state)
        p = state.round + 1
        idx = self.churn.active_devices(self.fc.seed, p,
                                        self.fc.num_devices)
        jdx = torch.as_tensor(idx, device=self.device)
        cohort = state.replace(
            dev_params=_map(lambda t: t[jdx], state.dev_params),
            dev_gout=state.dev_gout[jdx])
        plan = self.trainer.link_plan(state.g_params, n_links=len(idx))
        with deterministic_cudnn(self.device):
            cohort, rec = self._program.step(
                cohort, {"dev_x": pool_x[jdx], "dev_y": pool_y[jdx],
                         "test_x": test_x, "test_y": test_y, "plan": plan,
                         "log": log})
        self.state = cohort.replace(
            dev_params={k: {n: t.index_copy(0, jdx, cohort.dev_params[k][n])
                            for n, t in v.items()}
                        for k, v in state.dev_params.items()},
            dev_gout=state.dev_gout.index_copy(0, jdx, cohort.dev_gout))
        # the devices that trained: the churned cohort, narrowed by
        # round_once's client sampling (rec["cohort"] indexes into it)
        active = idx if rec["cohort"] is None else idx[rec["cohort"]]
        if self._acct is not None:
            # budget is spent by participating devices only
            self._acct.step(cohort=active)
            rec["dp_epsilon"] = self._acct.epsilon()
            rec["dp_epsilon_device_max"] = self._acct.epsilon_device_max()
        rec["n_active"] = len(active)
        rec["active"] = active
        self.history.append(rec)
        if self.ckpt_dir and p % self.ckpt_every == 0:
            self.save_checkpoint()
        return rec

    def run_rounds(self, n: int, log=None) -> list[dict]:
        """Drive ``n`` rounds."""
        return [self.step(log=log) for _ in range(n)]

    def serve(self, x) -> np.ndarray:
        """Answer one request batch against the current global model
        (between rounds; the training state is not touched)."""
        self.endpoint.submit(x)
        return self.endpoint.flush(self.state.g_params)

    def _history_meta(self) -> list[dict]:
        return [{k: r.get(k) for k in
                 _RECORD_KEYS + ("n_active", "dp_epsilon",
                                 "dp_epsilon_device_max")
                 if k in r} for r in self.history]

    def save_checkpoint(self) -> str:
        """Write the resumable state: tensors in the step dir (the run
        key as the reference's two uint32 words), host scalars in the
        meta.  ``prev`` is absent before the first round, ``seeds`` on
        the protocols without a seed exchange."""
        if not self.ckpt_dir:
            raise RuntimeError("service has no ckpt_dir")
        state = RoundState.from_mapping(self.state)
        tree = {"key": state.key.cpu().numpy().astype(np.uint32),
                "g_params": state.g_params,
                "dev_params": state.dev_params,
                "gout": state.gout,
                "dev_gout": state.dev_gout}
        if state.prev is not None:
            tree["prev"] = state.prev
        if state.seeds is not None:
            tree["seeds"] = {"train_x": state.seeds["train_x"],
                             "train_y": state.seeds["train_y"]}
        if self._seed_meta is None and state.seeds is not None \
                and "uploaded" in state.seeds:
            # only the run that collected the round-1 set holds all of
            # it; its summary rides along in every checkpoint
            self._seed_meta = summarize_seeds(state.seeds)
        meta = {"round": state.round,
                "cum_time_s": state.cum_time_s,
                "converged_round": state.converged_round,
                "protocol": self.fc.protocol,
                "dp_rounds": (self._acct.rounds
                              if self._acct is not None else 0),
                "dp_device_counts": (
                    self._acct.device_counts.tolist()
                    if self._acct is not None else None),
                "seed_meta": self._seed_meta,
                "history": self._history_meta()}
        return checkpoint.save(self.ckpt_dir, state.round, tree,
                               meta=meta, keep=self.keep)

    def restore(self, step: Optional[int] = None) -> int:
        """Rebuild the state from the newest (or the ``step``-th)
        checkpoint on the service's device; returns the restored round.
        The draws dispatched before the restore are dropped."""
        if not self.ckpt_dir:
            raise RuntimeError("service has no ckpt_dir")
        tree, meta = checkpoint.restore_tree(self.ckpt_dir, step)

        def put(a):
            return torch.as_tensor(a, device=self.device)

        self.state = RoundState(
            round=meta["round"],
            key=put(tree["key"].astype(np.int64)),
            g_params=_map(put, tree["g_params"]),
            dev_params=_map(put, tree["dev_params"]),
            gout=put(tree["gout"]),
            dev_gout=put(tree["dev_gout"]),
            prev=put(tree["prev"]) if "prev" in tree else None,
            converged_round=meta["converged_round"],
            seeds=_map(put, tree["seeds"]) if "seeds" in tree else None,
            cum_time_s=meta["cum_time_s"])
        self.history = list(meta.get("history", []))
        self._program.finalize()
        self._seed_meta = meta.get("seed_meta")
        if self._acct is not None:
            self._acct.rounds = meta.get("dp_rounds", 0)
            counts = meta.get("dp_device_counts")
            if counts is not None:
                self._acct.device_counts = np.asarray(counts, np.int64)
            else:
                # older checkpoints keep a str-keyed dict
                self._acct.device_rounds = {
                    int(k): int(v) for k, v in
                    (meta.get("dp_device_rounds") or {}).items()}
        return meta["round"]


# ---------------------------------------------------------------------------
# CLI smoke: N rounds with checkpoints, one served batch, and optionally a
# restore of the halfway checkpoint whose tail must equal the first run's
# ---------------------------------------------------------------------------

def _smoke_setup(args, ckpt_dir):
    from ..data import partition_iid
    from ..data.pipeline import parse_task

    task = parse_task(args.task)
    x, y = task.data(rng.PRNGKey(42), 1400, device=args.device)
    dev_x, dev_y = partition_iid(x[:1200], y[:1200], 4, 300,
                                 task.num_classes, seed=0)
    fc = FederatedConfig(protocol=args.protocol, num_devices=4,
                         local_iters=8, local_batch=16, server_iters=8,
                         server_batch=16, max_rounds=args.rounds,
                         n_seed=6, n_inverse=12, seed=0, model=args.model,
                         task=task.name)
    ch = ChannelConfig(num_devices=4, p_up_dbm=40.0,
                       compute_mean_s=args.compute_mean_s,
                       deadline_s=args.deadline_s)
    svc = FederatedService(
        None, fc, ch, churn=ChurnConfig(p_active=args.p_active,
                                        min_active=2),
        ckpt_dir=ckpt_dir, ckpt_every=1,
        options=ProgramOptions(pipeline_depth=args.pipeline_depth),
        device=args.device)
    return svc.bind_data(dev_x, dev_y, x[1200:], y[1200:])


def _tail(records):
    return [{k: r[k] for k in ("round", "acc", "loss", "round_latency_s",
                               "uplink_ok")} for r in records]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="continuous federated service smoke")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--protocol", default="mix2fld")
    ap.add_argument("--model", default="cnn",
                    help="registry model to train and serve (cnn, mlp; "
                         "homogeneous only)")
    ap.add_argument("--task", default="digits",
                    help="registry task shaping the synthetic workload")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary "
                         "one, removed at exit)")
    ap.add_argument("--p-active", type=float, default=0.75)
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    dest="pipeline_depth",
                    help="rounds of link draws in flight (1 = serial; "
                         "2 = double-buffered)")
    ap.add_argument("--compute-mean-s", type=float, default=0.05,
                    dest="compute_mean_s")
    ap.add_argument("--deadline-s", type=float, default=0.15,
                    dest="deadline_s")
    ap.add_argument("--verify-resume", action="store_true",
                    help="restore the halfway checkpoint into a fresh "
                         "service, re-run the tail, and require "
                         "identical per-round records")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None:
        return _smoke(args, args.ckpt_dir)
    with tempfile.TemporaryDirectory(prefix="fedsvc_") as d:
        return _smoke(args, d)


def _smoke(args, ckpt_dir) -> int:
    svc = _smoke_setup(args, ckpt_dir)
    recs = svc.run_rounds(args.rounds, log=print)
    pstats = svc._program.finalize()
    print(f"trained {args.rounds} rounds on {svc.device}: final "
          f"acc={recs[-1]['acc']:.3f} cohort sizes="
          f"{[r['n_active'] for r in recs]} stragglers dropped="
          f"{sum(r['n_straggle'] for r in recs)} pipeline={pstats}")
    preds = svc.serve(svc._data[0][0][: svc.endpoint.batch_size])
    print(f"served {preds.shape[0]} predictions "
          f"(endpoint batches={svc.endpoint.batches})")
    if args.verify_resume:
        mid = max(1, args.rounds // 2)
        svc2 = _smoke_setup(args, ckpt_dir)
        got = svc2.restore(step=mid)
        if got != mid:
            print(f"RESUME MISMATCH: restored round {got}, wanted {mid}")
            return 1
        want, have = _tail(recs[mid:]), _tail(svc2.run_rounds(
            args.rounds - mid))
        if want != have:
            print(f"RESUME MISMATCH:\n  want {want}\n  have {have}")
            return 1
        print(f"resume verified: rounds {mid + 1}..{args.rounds} "
              f"bit-identical after restore from step {mid}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
