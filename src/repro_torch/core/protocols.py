"""Protocol engines: FL, FD, FLD, MixFLD, Mix2FLD (Algorithm 1).

The federated population is simulated as in Sec. II: per-round local SGD
at every device, Rayleigh-faded uplink/downlink with SNR-gated success,
weighted aggregation over the successful set, and — for the FLD family
— the server-side output-to-model conversion of eq. (5).

The device axis is explicit: parameters are stacked ``(D, ...)`` and
the CNN runs the whole population as one grouped convolution
(``CNN.apply_stacked``), where the reference vmaps over devices.  A
local SGD step sends every device's logits through one launch of the
fused distill step kernel, and on the GPU the steps of local SGD and of
the eq. (5) conversion are replays of a captured CUDA graph
(``core/graphs.py``).  ``FederatedTrainer.run`` loops over
:meth:`FederatedTrainer.round_once` directly (the reference's
``LoopRoundProgram`` at depth 1).

Not ported in this slice, and refused by :class:`FederatedConfig`:
client sampling, mixed-architecture cohorts, the non-identity codecs,
the cifar/speech tasks (ROADMAP A10), the straggler stage and the
service (A11), the sweep grid step (A12) and the mesh-sharded path
(A13).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import rng
from ..channel import ChannelConfig
from ..channel.payload import check_codec
from ..channel.pipeline import (LinkPlan, downlink_gout, downlink_params,
                                make_uplink_stage)
from ..data.pipeline import TaskSpec, parse_task
from ..device import resolve_device
from ..models.cnn import CNN
from ..kernels.distill_loss import distill_step
from ..registry import FLD_FAMILY, PROTOCOLS, canonical_protocol  # noqa: F401
from .conversion import OutputToModel
from .graphs import CapturedSteps
from .seed_prep import collect_seeds, summarize_seeds
from .state import RoundState

_MODEL_ALIASES = {"cnn": "cnn", "conv": "cnn", "paper_cnn": "cnn"}


@dataclasses.dataclass
class FederatedConfig:
    """The reference's fields and defaults (the paper's Sec. IV values).
    Values this slice does not run raise NotImplementedError."""
    protocol: str = "mix2fld"
    num_devices: int = 10          # |D|
    num_classes: Optional[int] = None  # N_L (None: the task's)
    local_iters: int = 200         # K   (paper: 6400 single-sample SGD)
    local_batch: int = 16          # samples per local SGD iteration
    server_iters: int = 160        # K_s (paper: 3200)
    server_batch: int = 16
    eta: float = 0.01
    beta: float = 0.01
    eps: float = 0.05
    lam: float = 0.1               # Mixup ratio
    n_seed: int = 10               # N_S per device
    n_inverse: int = 20            # N_I per device-equivalent (>= N_S)
    max_rounds: int = 20
    sample_bits: Optional[int] = None  # per-sample uplink bits (None:
    #                                the task's, 8 bit * 28 * 28 = 6272)
    seed: int = 0
    shard_devices: bool = False
    mesh_shards: int = 0
    keep_seed_arrays: bool = False  # keep the round-1 seed arrays on
    #                                history["seed_arrays"]
    codec: str = "identity"
    quant_bits: int = 8
    dp_sigma: float = 1.0
    dp_clip: float = 1.0
    dp_delta: float = 1e-5
    sample_ratio: float = 1.0
    sample_seed: int = 0
    sample_min_active: int = 1
    model: str = "cnn"
    task: str = "digits"
    model_partition: Optional[tuple] = None
    sampler: Optional[object] = None
    churn: Optional[object] = None
    channel: Optional[object] = None

    def __post_init__(self):
        self.protocol = canonical_protocol(self.protocol)
        spec = parse_task(self.task)
        self.task = spec.name
        if self.num_classes is None:
            self.num_classes = spec.num_classes
        if self.sample_bits is None:
            self.sample_bits = spec.sample_bits
        if not 0.0 < self.sample_ratio <= 1.0:
            raise ValueError(f"sample_ratio must be in (0, 1], got "
                             f"{self.sample_ratio}")
        if self.sample_ratio < 1.0 or self.sampler is not None:
            raise NotImplementedError(
                "client sampling is not ported yet (ROADMAP A10)")
        if self.churn is not None:
            raise NotImplementedError(
                "device churn is not ported yet (ROADMAP A11)")
        if self.channel is not None:
            raise NotImplementedError(
                "the typed LinkConfig is not ported yet (ROADMAP A10); "
                "set codec='identity'")
        check_codec(self.codec)
        if self.shard_devices:
            raise NotImplementedError(
                "the mesh-sharded device axis is not ported yet "
                "(ROADMAP A13)")
        model = _MODEL_ALIASES.get(self.model)
        if model is None or self.model_partition is not None:
            raise NotImplementedError(
                f"model {self.model!r} / model_partition are not ported "
                "yet (ROADMAP A10); the port runs the paper CNN")
        self.model = model
        if self.n_seed < 1:
            raise ValueError(f"n_seed must be >= 1, got {self.n_seed}")
        if self.n_inverse < 1:
            raise ValueError(f"n_inverse must be >= 1, got {self.n_inverse}")
        if not 0.0 <= self.lam <= 1.0:
            raise ValueError(f"lam is a mixing ratio in [0, 1], "
                             f"got {self.lam}")

    def task_spec(self) -> TaskSpec:
        return parse_task(self.task)


# ---------------------------------------------------------------------------
# Per-round pieces
# ---------------------------------------------------------------------------

def make_local_train(apply_stacked, num_classes: int, local_iters: int,
                     local_batch: int):
    """Local SGD (eq. 1 / 3) for a device-stacked population.

    Returns ``local_train(params, x, y, keys, gout, use_kd, eta, beta,
    n_loc) -> (params, favg (D, C, C), cnt (D, C), mean loss (D,))`` with
    ``params`` leaves (D, ...), x (D, n, ...), y (D, n) int64, keys
    (D, 2), gout (D, C, C).  Device d draws its batches from keys[d]
    exactly as the reference's vmapped scan does.  ``params`` is not
    changed; the returned tensors are the caller's own.
    """
    return LocalTrain(apply_stacked, num_classes, local_iters, local_batch)


class LocalTrain:
    """:func:`make_local_train`'s callable.  Each input layout (and eta)
    gets static buffers and a :class:`~repro_torch.core.graphs.StepGraph`
    of one step (``core/graphs.py`` :class:`CapturedSteps`), built at
    first use and kept: on the GPU the K steps are graph replays, on the
    CPU the same step runs eagerly.

    One step: gather the batch by the step's indices, ``apply_stacked``,
    :func:`~repro_torch.kernels.distill_loss.distill_step` (the loss,
    its gradient dz in the logits and the eq. (2) sums, every device's
    rows in one kernel launch), ``autograd.grad`` of ``sum(logits dz)``
    into the stacked leaves, and the SGD update ``p - (eta g)`` as two
    foreach ops.
    """

    def __init__(self, apply_stacked, num_classes: int, local_iters: int,
                 local_batch: int):
        self.apply_stacked = apply_stacked
        self.C, self.K, self.B = num_classes, local_iters, local_batch
        self.steps = CapturedSteps()

    @property
    def graphs(self):
        return self.steps.graphs

    def _make_step(self, eta):
        apply_stacked, B = self.apply_stacked, self.B

        def make(buf):
            inp, out, k = buf.inputs, buf.outputs, buf.k
            D = inp["x"].shape[0]
            rows = torch.arange(D, device=k.device)[:, None]

            def step():
                ik = inp["idx"].index_select(1, k).view(D, B)
                xb, yb = inp["x"][rows, ik], inp["y"][rows, ik]
                logits = apply_stacked(buf.params, xb)       # (D, B, C)
                dz = distill_step(logits.detach(), yb, inp["gout"],
                                  inp["beta"], k, out["losses"],
                                  out["out_sum"], out["cnt"])
                # devices are independent: dz is each device's own
                # gradient.  sum(logits * dz) is a scalar root whose
                # gradient in the logits is dz exactly;
                # autograd.grad(logits, grad_outputs=dz) would import
                # PyTorch's symbolic-shape module (sympy) at its first
                # call, seconds of host time
                grads = torch.autograd.grad((logits * dz).sum(), buf.leaves)
                with torch.no_grad():
                    torch._foreach_sub_(buf.leaves,
                                        torch._foreach_mul(grads, eta))
                    k.add_(1)

            return step

        return make

    def __call__(self, params, x, y, keys, gout, use_kd, eta, beta, n_loc):
        C, K, B = self.C, self.K, self.B
        D = x.shape[0]
        idx = rng.randint(rng.split(keys, K), (B,), 0, n_loc)  # (D, K, B)
        b = torch.full((1,), beta if use_kd else 0.0, device=x.device)
        new, out = self.steps(
            self._make_step(eta), params,
            dict(x=x, y=y, idx=idx, gout=gout, beta=b),
            dict(out_sum=(D, C, C), cnt=(D, C), losses=(D, K)), K,
            key=(eta,))
        cnt = out["cnt"]
        favg = out["out_sum"] / cnt[:, :, None].clamp_min(1.0)
        return new, favg, cnt, out["losses"].mean(1)


def weighted_avg(stacked, weights):
    """Weighted model average over the device axis (uplink-success set)."""
    wsum = weights.sum().clamp_min(1e-9)
    return {k: {n: torch.tensordot(weights, t, dims=1) / wsum
                for n, t in v.items()} for k, v in stacked.items()}


def gout_update(favg, cnt, ok):
    """eq. 2: per-class output average over the successful device set."""
    cw = ok[:, None] * cnt                  # (D, C) per-class weights
    num = torch.einsum("dc,dcm->cm", cw, favg)
    den = cw.sum(0)
    return num / den[:, None].clamp_min(1.0)


def _flat(params):
    return torch.cat([t.reshape(-1) for v in params.values()
                      for t in v.values()])


class FederatedTrainer:
    """Runs one protocol over a simulated device population.

    model: a :class:`~repro_torch.models.cnn.CNN` (or None to build the
    paper CNN for ``fc.task``).  ``device``: where everything runs —
    the GPU by default; pass ``"cpu"`` to run on the CPU.
    """

    def __init__(self, model, fc: FederatedConfig,
                 ch: Optional[ChannelConfig] = None, device=None):
        self.fc = fc
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # cuDNN's float32 convolutions default to TF32 (~3 digits);
            # the port computes in full float32, like the reference
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        if model is None:
            model = CNN(fc.num_classes, fc.task_spec().input_shape)
        self.model = model
        self.ch = ch or ChannelConfig(num_devices=fc.num_devices)
        self.local_train = make_local_train(
            model.apply_stacked, fc.num_classes, fc.local_iters,
            fc.local_batch)
        self.output_to_model = OutputToModel(model.apply)
        self._uplink_stage = make_uplink_stage(fc.codec, fc.protocol)
        self._plan_cache = {}

    def init_state(self, num_devices: Optional[int] = None) -> RoundState:
        """Fresh :class:`RoundState`: the reference's key schedule (``key``
        is the second ``split(PRNGKey(seed))`` output) and a common init
        on every device."""
        fc = self.fc
        D = fc.num_devices if num_devices is None else num_devices
        C = fc.num_classes
        kinit, key = rng.split(rng.PRNGKey(fc.seed, self.device), 2)
        g_params = self.model.init(kinit)
        dev_params = {k: {n: t.expand((D,) + t.shape).clone()
                          for n, t in v.items()}
                      for k, v in g_params.items()}
        gout = torch.full((C, C), 1.0 / C, device=self.device)
        dev_gout = gout.expand(D, C, C).clone()
        return RoundState(round=0, key=key, g_params=g_params,
                          dev_params=dev_params, gout=gout,
                          dev_gout=dev_gout)

    def link_plan(self, g_params, n_links: Optional[int] = None) -> LinkPlan:
        """The link plan for an ``n_links``-device cohort (cached)."""
        fc = self.fc
        n_links = fc.num_devices if n_links is None else n_links
        plan = self._plan_cache.get(n_links)
        if plan is None:
            plan = LinkPlan.build(fc.protocol, self.ch,
                                  n_mod=self.model.num_params(g_params),
                                  n_labels=fc.num_classes,
                                  sample_bits=fc.sample_bits,
                                  n_seed=fc.n_seed, codec=fc.codec,
                                  n_links=n_links)
            self._plan_cache[n_links] = plan
        return plan

    def _tensor(self, a, dtype):
        if torch.is_tensor(a):
            return a.to(self.device, dtype)
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def accuracy(self, params, x, y) -> float:
        with torch.no_grad():
            logits = self.model.apply(params, x)
        return float((logits.argmax(-1) == y).to(torch.float32).mean())

    def round_once(self, state: RoundState, dev_x, dev_y, test_x, test_y,
                   *, plan: Optional[LinkPlan] = None, log=None):
        """One federated round.  Returns ``(new_state, record)``.  The round
        number and every draw derive from ``state``; the tensors must lie
        on the trainer's device (``run`` moves them there)."""
        fc = self.fc
        proto = fc.protocol
        D, n_local = dev_x.shape[:2]
        p = state.round + 1

        t0 = time.perf_counter()
        kr = rng.fold_in(state.key, p)
        use_kd = proto != "fl" and p > 1  # KD once G_out exists
        g_params, gout, seeds = state.g_params, state.gout, state.seeds
        if plan is None or plan.n_links != D:
            plan = self.link_plan(g_params, n_links=D)

        # ---- local updates (eq. 1 / 3) ----
        dkeys = rng.split(rng.fold_in(kr, 1), D)
        dev_params, favg, cnt, mloss = self.local_train(
            state.dev_params, dev_x, dev_y, dkeys, state.dev_gout, use_kd,
            fc.eta, fc.beta, n_local)
        self._sync()
        local_s = time.perf_counter() - t0

        # ---- seed collection (first round, FLD family) ----
        if p == 1 and proto in FLD_FAMILY:
            seeds = collect_seeds(fc, dev_x, dev_y, rng.fold_in(kr, 2))

        # ---- link pipeline: encode -> channel -> decode ----
        link = plan.draw(rng.fold_in(kr, 3), first_round=p == 1)
        up_ok, dn_ok = link["up_ok"], link["dn_ok"]
        ok = torch.as_tensor(up_ok, device=self.device)
        dev_params_rx, favg_rx = self._uplink_stage(
            dev_params, favg, rng.fold_in(kr, 5), state.dev_gout, g_params)

        # ---- aggregation + (FLD) conversion ----
        if proto == "fl":
            if up_ok.any():
                w = ok.to(torch.float32) * n_local   # |S_d| weights
                g_params = weighted_avg(dev_params_rx, w)
        else:
            if up_ok.any():
                gout = gout_update(favg_rx, cnt, ok.to(torch.float32))
            if proto != "fd":
                g_params, _ = self.output_to_model(
                    g_params, seeds["train_x"],
                    seeds["train_y"], gout, fc.server_iters,
                    fc.server_batch, fc.eta, fc.beta, rng.fold_in(kr, 4))

        # ---- downlink (gated per device by dn_ok) ----
        mask = torch.as_tensor(dn_ok, device=self.device)
        dev_gout = downlink_gout(state.dev_gout, gout, mask)
        if proto != "fd":
            dev_params = downlink_params(dev_params, g_params, mask)
        self._sync()
        compute_s = time.perf_counter() - t0
        cum_time = state.cum_time_s + compute_s + link["latency_s"]

        # ---- evaluation of the reference device (device 0) ----
        ref = {k: {n: t[0] for n, t in v.items()}
               for k, v in dev_params.items()}
        acc = self.accuracy(ref, test_x, test_y)
        loss = float(mloss.mean())
        if log:
            log(f"[{proto}] round {p}: acc={acc:.3f} loss={loss:.3f} "
                f"up_ok={up_ok.sum()}/{D} "
                f"lat={link['latency_s']*1e3:.0f}ms "
                f"compute_s={compute_s:.3f} local_s={local_s:.3f}")

        # ---- convergence (relative change < eps) ----
        flat = gout.reshape(-1) if proto == "fd" else _flat(g_params)
        converged_round = state.converged_round
        if state.prev is not None:
            rel = float(torch.linalg.vector_norm(flat - state.prev) /
                        torch.linalg.vector_norm(state.prev).clamp_min(
                            1e-12))
            # a total-outage round leaves the global state untouched:
            # rel == 0 there means "nothing arrived", not convergence
            if rel < fc.eps and converged_round is None and up_ok.any():
                converged_round = p

        new_state = RoundState(round=p, key=state.key, g_params=g_params,
                               dev_params=dev_params, gout=gout,
                               dev_gout=dev_gout, prev=flat,
                               converged_round=converged_round,
                               seeds=seeds, cum_time_s=cum_time)
        record = {"round": p, "acc": acc, "loss": loss,
                  "round_latency_s": link["latency_s"],
                  "compute_s": compute_s, "local_s": local_s,
                  "cum_time_s": cum_time,
                  "uplink_ok": int(up_ok.sum()), "n_active": D,
                  "link": link}
        return new_state, record

    def run(self, dev_x, dev_y, test_x, test_y, log=None):
        """Full protocol run over ``fc.max_rounds`` rounds.  Data may be
        numpy arrays or tensors; it is moved to the trainer's device.
        Returns the history dict (per-round accuracy, losses, latency,
        cumulative time, seed metadata)."""
        fc = self.fc
        dev_x, test_x = (self._tensor(a, torch.float32)
                         for a in (dev_x, test_x))
        dev_y, test_y = (self._tensor(a, torch.int64)
                         for a in (dev_y, test_y))
        state = self.init_state(dev_x.shape[0])
        plan = self.link_plan(state.g_params, n_links=dev_x.shape[0])
        history = {"acc": [], "round_latency_s": [], "compute_s": [],
                   "local_s": [], "cum_time_s": [], "loss": [], "uplink_ok": [],
                   "converged_round": None, "protocol": fc.protocol,
                   "model": fc.model, "task": fc.task, "codec": fc.codec,
                   "sample_ratio": fc.sample_ratio,
                   "cohort_size": fc.num_devices,
                   "uplink_bits_first": plan.up_bits_first,
                   "uplink_bits": plan.up_bits,
                   "downlink_bits": plan.dn_bits,
                   "device": str(self.device)}
        for _ in range(fc.max_rounds):
            state, rec = self.round_once(state, dev_x, dev_y, test_x,
                                         test_y, plan=plan, log=log)
            for k in ("acc", "loss", "round_latency_s", "compute_s",
                      "local_s", "cum_time_s", "uplink_ok"):
                history[k].append(rec[k])
        history["converged_round"] = state.converged_round
        history["seeds"] = summarize_seeds(state.seeds)
        if fc.keep_seed_arrays:
            history["seed_arrays"] = state.seeds
        history["final_acc"] = history["acc"][-1]
        self.last_dev_gout = state.dev_gout
        return history
