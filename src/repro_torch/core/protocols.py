"""Protocol engines: FL, FD, FLD, MixFLD, Mix2FLD (Algorithm 1).

The federated population is simulated as in Sec. II: per-round local SGD
at every device, Rayleigh-faded uplink/downlink with SNR-gated success,
weighted aggregation over the successful set, and — for the FLD family
— the server-side output-to-model conversion of eq. (5).

The device axis is explicit: parameters are stacked ``(D, ...)`` and a
model runs the whole population at once (``apply_stacked``: the CNN as
one grouped convolution, the MLP as one ``bmm`` a layer, the transformer
classifier one device after another), where the reference vmaps over
devices.  A local SGD step sends every device's
logits through one launch of the fused distill step kernel, and on the
GPU the steps of local SGD and of the eq. (5) conversion are replays of
a captured CUDA graph (``core/graphs.py``).  A mixed-architecture cohort
(``model="cnn+mlp"``, FD family only) trains each architecture group
with its own local train, so its own graph.  Client sampling
(``sample_ratio < 1``) gathers the round's cohort off the pool before
local SGD and scatters it back after the downlink.
``FederatedTrainer.run`` drives :meth:`FederatedTrainer.round_once`
through a ``core/program.py`` :class:`LoopRoundProgram`, as the service
(``launch/service.py``) does with churned cohorts.

With ``shard_devices=True`` the device axis is split over the ranks of
a ("data",) mesh (``launch/mesh.py``; the reference's ``shard_map``):
each rank runs local SGD on its own rows of the cohort, and the two
aggregations are :func:`weighted_avg_psum` and :func:`gout_update_psum`,
a partial sum over the rank's rows and one all-reduce each.  Everything
else sees the whole ``(D, ...)`` arrays on every rank, as the reference's
GSPMD presents them: the trained rows are gathered (one all-gather a
round), and the seed exchange, the link draw, the codec stage, the
conversion, the downlink and the evaluation run on each rank alike,
under cuDNN's deterministic algorithms on a GPU so that the replicas
stay equal bit for bit.  On one rank the sharded path equals the
vmapped one bit for bit.

:func:`make_grid_round_step` is the same round for a sweep group of G
points stacked (``sweep/engine.py``): G x D device rows through one
captured local step, per-point values as tensors, and every host
decision of the loop as a masked tensor operation.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import rng
from ..channel import ChannelConfig
from ..channel.payload import CodecSpec, LinkConfig, parse_codec
from ..channel.pipeline import (LinkPlan, downlink_gout, downlink_params,
                                grid_uplink_stage, make_uplink_stage,
                                round_trip_traced)
from ..data.pipeline import TaskSpec, parse_task
from ..device import deterministic_cudnn, resolve_device
from ..kernels.distill_loss import distill_step
from ..launch.mesh import (all_gather_rows, all_reduce_sum, make_device_mesh,
                           mesh_coordinate)
from ..models.registry import ModelSpec, build_model, parse_model
from ..registry import (FLD_FAMILY, MODELS, PROTOCOLS,  # noqa: F401
                        canonical_model, canonical_protocol)
from .conversion import OutputToModelSteps
from .graphs import CapturedSteps
from .privacy import GaussianAccountant
from .program import LoopRoundProgram, ProgramOptions
from .sampling import ChurnConfig, SamplerConfig
from .seed_prep import collect_seeds, summarize_seeds
from .state import RoundState


@dataclasses.dataclass
class FederatedConfig:
    """The reference's fields and defaults (the paper's Sec. IV values).
    ``sampler`` and ``channel`` are the typed sub-configs; the flat
    ``sample_*`` and ``codec``/``quant_bits``/``dp_*`` fields are their
    aliases, reconciled as the reference does."""
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
    codec: str = "identity"        # link codec: "quantize8", "delta",
    #                                "dp_gaussian0.5", ... (channel.payload)
    quant_bits: int = 8
    dp_sigma: float = 1.0
    dp_clip: float = 1.0
    dp_delta: float = 1e-5
    sample_ratio: float = 1.0      # per-round participation fraction q
    sample_seed: int = 0
    sample_min_active: int = 1
    model: str = "cnn"             # "cnn", "mlp", or a "+"-joined cohort
    #                                ("cnn+mlp", FD family only)
    task: str = "digits"           # "digits", "cifar", "speech"
    model_partition: Optional[tuple] = None  # per-device architectures
    sampler: Optional[SamplerConfig] = None
    churn: Optional[ChurnConfig] = None
    channel: Optional[LinkConfig] = None

    #: flat alias -> sub-config attribute, per sub-config field
    _SUB_ALIASES = {
        "sampler": (SamplerConfig, {"sample_ratio": "sample_ratio",
                                    "sample_seed": "seed",
                                    "sample_min_active": "min_active"}),
        "channel": (LinkConfig, {"codec": "codec",
                                 "quant_bits": "quant_bits",
                                 "dp_sigma": "dp_sigma",
                                 "dp_clip": "dp_clip",
                                 "dp_delta": "dp_delta"}),
    }

    def _sync_sub(self, attr: str) -> None:
        """Reconcile one typed sub-config with its flat aliases, as the
        reference does: no sub-config builds it from the aliases (with a
        DeprecationWarning when an alias was set); a sub-config with the
        aliases at their defaults is canonical; both set and disagreeing,
        the aliases win.  The aliases then mirror the sub-config."""
        cls, aliases = self._SUB_ALIASES[attr]
        defaults = cls()
        sub = getattr(self, attr)
        flats = {f: getattr(self, f) for f in aliases}
        changed = sorted(f for f in aliases
                         if flats[f] != getattr(defaults, aliases[f]))
        if sub is None:
            if changed:
                warnings.warn(
                    f"flat FederatedConfig fields {changed} are "
                    f"deprecated; pass {attr}={cls.__name__}(...) "
                    "instead", DeprecationWarning, stacklevel=4)
            sub = cls(**{aliases[f]: flats[f] for f in aliases})
        elif changed and \
                any(flats[f] != getattr(sub, aliases[f]) for f in aliases):
            sub = cls(**{aliases[f]: flats[f] for f in aliases})
        object.__setattr__(self, attr, sub)
        for f in aliases:
            object.__setattr__(self, f, getattr(sub, aliases[f]))

    def __post_init__(self):
        self.protocol = canonical_protocol(self.protocol)
        self.task = parse_task(self.task).name
        if self.num_classes is None:
            self.num_classes = self.task_spec().num_classes
        if self.sample_bits is None:
            self.sample_bits = self.task_spec().sample_bits
        self._sync_sub("sampler")
        self._sync_sub("channel")
        if self.churn is not None:
            if not isinstance(self.churn, ChurnConfig):
                raise TypeError(f"churn must be a ChurnConfig, "
                                f"got {type(self.churn).__name__}")
        mspec = parse_model(self.model)
        self.model = mspec.name
        if self.model_partition is None:
            if mspec.mixed:
                self.model_partition = mspec.partition(self.num_devices)
        else:
            part = tuple(canonical_model(m) for m in self.model_partition)
            if len(part) != self.num_devices:
                raise ValueError(
                    f"model_partition has {len(part)} entries for "
                    f"num_devices={self.num_devices}")
            # a uniform partition of the single model is the homogeneous
            # cohort
            self.model_partition = (
                None if set(part) == {self.model} else part)
        if self.model_partition is not None:
            # mixed cohorts exchange outputs: only the FD-family uplink
            # aggregates in the shared (C, C) output space
            if self.protocol == "fl":
                raise ValueError(
                    "protocol 'fl' aggregates parameter vectors and "
                    "cannot mix architectures; a mixed-model cohort "
                    f"({self.model!r}) needs an FD-family uplink — one "
                    "of ('fd',) + FLD_FAMILY "
                    f"{FLD_FAMILY}")
            if self.shard_devices:
                raise ValueError(
                    "mixed-architecture cohorts are not supported on the "
                    "mesh-sharded path (shard_devices=True): per-device "
                    "parameter pytrees differ across shards")
            if self.sample_ratio < 1.0:
                raise ValueError(
                    "mixed-architecture cohorts require full "
                    f"participation (sample_ratio=1.0, got "
                    f"{self.sample_ratio}): a sampled cohort would need "
                    "ragged per-architecture gathers")
        if self.n_seed < 1:
            raise ValueError(f"n_seed must be >= 1, got {self.n_seed}")
        if self.n_inverse < 1:
            raise ValueError(f"n_inverse must be >= 1, got {self.n_inverse}")
        if not 0.0 <= self.lam <= 1.0:
            raise ValueError(f"lam is a mixing ratio in [0, 1], "
                             f"got {self.lam}")

    def codec_spec(self) -> CodecSpec:
        """The resolved link codec of ``channel``."""
        return self.channel.spec()

    def cohort_size(self, pool_size: Optional[int] = None) -> int:
        """Devices training per round: ``num_devices`` (or
        ``pool_size``) unless sampling shrinks it."""
        pool = self.num_devices if pool_size is None else pool_size
        return self.sampler.cohort_size(pool)

    def task_spec(self) -> TaskSpec:
        return parse_task(self.task)

    def model_spec(self) -> ModelSpec:
        """The parsed model spec (``parts[0]`` is the server's)."""
        return parse_model(self.model)

    def server_model(self) -> str:
        """The global (server-side) architecture name."""
        return self.model_spec().parts[0]

    def model_key(self) -> str:
        """The composite name when the per-device assignment is the
        spec's round-robin cycle, the explicit assignment otherwise, the
        single name for homogeneous cohorts."""
        if self.model_partition is None:
            return self.model
        parts = self.model_spec().parts
        cyc = tuple(parts[i % len(parts)] for i in range(self.num_devices))
        if tuple(self.model_partition) == cyc:
            return self.model
        return "+".join(self.model_partition)

    def arch_groups(self):
        """None for homogeneous cohorts; else ``[(name, np.int32
        indices), ...]`` in first-appearance order over the partition (the
        first group holds device 0)."""
        if self.model_partition is None:
            return None
        part = self.model_partition
        return [(m, np.flatnonzero(np.asarray(part) == m).astype(np.int32))
                for m in dict.fromkeys(part)]

    def build_models(self) -> dict:
        """Registry-built classifiers for every architecture this config
        trains (the server's included)."""
        shape = self.task_spec().input_shape
        names = list(self.model_partition or (self.server_model(),))
        names.append(self.server_model())
        return {m: build_model(m, shape, self.num_classes)
                for m in dict.fromkeys(names)}


# ---------------------------------------------------------------------------
# Per-round pieces
# ---------------------------------------------------------------------------

def make_local_train(apply_stacked, num_classes: int, local_iters: int,
                     local_batch: int):
    """Local SGD (eq. 1 / 3) for a device-stacked population.

    Returns ``local_train(params, x, y, keys, gout, use_kd, eta, beta,
    n_loc, rows=None) -> (params, favg (D, C, C), cnt (D, C), mean loss
    (D,))`` with ``params`` leaves (D, ...), keys (D, 2), gout (D, C, C).
    Device d trains on data row ``rows[d]`` of x (n, ...) and y (n,)
    int64 (default: row d).  ``eta``, ``beta`` and ``n_loc`` are numbers,
    or tensors of one value or of one per device.  Device d draws its
    batches from keys[d] exactly as the reference's vmapped scan does.
    ``params`` is not changed; the returned tensors are the caller's own.
    """
    return LocalTrain(apply_stacked, num_classes, local_iters, local_batch)


def _per_row(v, n: int, device, dtype=torch.float32):
    """``v`` (a number, or a tensor of 1 or n values) as an (n,) tensor
    on ``device``.  A number is filled in on the device: no host copy."""
    if torch.is_tensor(v):
        return v.to(device, dtype).reshape(-1).expand(n).contiguous()
    return torch.full((n,), v, dtype=dtype, device=device)


class LocalTrain:
    """:func:`make_local_train`'s callable, for a loop round (D devices)
    and a sweep grid's group (G configs x D devices, stacked) alike.
    Each input layout gets static buffers and a
    :class:`~repro_torch.core.graphs.StepGraph` of one step
    (``core/graphs.py`` :class:`CapturedSteps`), built at first use and
    kept: on the GPU the K steps are graph replays, on the CPU the same
    step runs eagerly.  eta, beta (zero while KD is off) and the data
    rows are per-device inputs of the step, so one capture serves every
    value of them.

    One step: gather the batch by the step's indices from each device's
    data row, ``apply_stacked``,
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

    def _make_step(self, buf):
        apply_stacked, B = self.apply_stacked, self.B
        inp, out, k = buf.inputs, buf.outputs, buf.k
        D = inp["idx"].shape[0]
        rows = inp["rows"][:, None]
        eta = [inp["eta"].view((-1,) + (1,) * (t.dim() - 1))
               for t in buf.leaves]

        def step():
            ik = inp["idx"].index_select(1, k).view(D, B)
            xb, yb = inp["x"][rows, ik], inp["y"][rows, ik]
            logits = apply_stacked(buf.params, xb)           # (D, B, C)
            dz = distill_step(logits.detach(), yb, inp["gout"],
                              inp["beta"], k, out["losses"],
                              out["out_sum"], out["cnt"])
            # devices are independent: dz is each device's own gradient.
            # sum(logits * dz) is a scalar root whose gradient in the
            # logits is dz exactly; autograd.grad(logits,
            # grad_outputs=dz) would import PyTorch's symbolic-shape
            # module (sympy) at its first call, seconds of host time
            grads = torch.autograd.grad((logits * dz).sum(), buf.leaves)
            with torch.no_grad():
                torch._foreach_sub_(buf.leaves,
                                    torch._foreach_mul(grads, eta))
                k.add_(1)

        return step

    def __call__(self, params, x, y, keys, gout, use_kd, eta, beta, n_loc,
                 rows=None):
        C, K, B = self.C, self.K, self.B
        D, dev = keys.shape[0], x.device
        if rows is None:
            rows = torch.arange(D, device=dev)
        beta = _per_row(beta, D, dev)
        if not use_kd:
            beta = torch.zeros_like(beta)
        idx = rng.randint(rng.split(keys, K), (B,), 0, n_loc)  # (D, K, B)
        new, out = self.steps(
            self._make_step, params,
            dict(x=x, y=y, rows=rows, idx=idx, gout=gout,
                 eta=_per_row(eta, D, dev), beta=beta),
            dict(out_sum=(D, C, C), cnt=(D, C), losses=(D, K)), K)
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


def _leaves(tree) -> list:
    return [t for v in tree.values() for t in v.values()]


def _rebuild(like, leaves):
    """A tree of ``like``'s keys holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return {k: {m: next(it) for m in v} for k, v in like.items()}


def _pack(tensors, n: int):
    """float32 tensors with n leading rows as one (n, F) block."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"the sharded path gathers float32 rows, got "
                             f"{t.dtype}")
    return torch.cat([t.reshape(n, -1) for t in tensors], 1)


def _split(flat, shapes, lead: tuple) -> list:
    """``flat`` (*lead, F) cut into contiguous tensors of the per-row
    ``shapes`` (a reduction over a strided view may sum in another order
    than over the contiguous tensor the unsharded path holds)."""
    out, i = [], 0
    for shape in shapes:
        n = 1
        for d in shape:
            n *= d
        out.append(flat[..., i:i + n].reshape(tuple(lead) + tuple(shape))
                   .contiguous())
        i += n
    return out


def _tensordot(w, t):
    return torch.tensordot(w, t, dims=1)


def _bmm(w, t):
    return torch.bmm(w[:, None], t.reshape(tuple(w.shape) + (-1,)))


def weighted_avg_psum(stacked, weights, mesh):
    """:func:`weighted_avg` on a ("data",) mesh: ``stacked`` and
    ``weights`` are the whole (D, ...) arrays, as on every rank
    (:meth:`GridShards.weighted_avg` with the unsharded tensordot)."""
    return GridShards(mesh, 1, weights.shape[0]).weighted_avg(
        stacked, weights, _tensordot)


def gout_update_psum(favg, cnt, ok, mesh):
    """:func:`gout_update` on a ("data",) mesh (:meth:`GridShards.
    gout_update` with the unsharded einsum)."""
    return GridShards(mesh, 1, cnt.shape[0]).gout_update(
        favg, cnt, ok, "dc,dcm->cm")


def _flat(params):
    return torch.cat([t.reshape(-1) for v in params.values()
                      for t in v.values()])


class FederatedTrainer:
    """Runs one protocol over a simulated device population.

    model: an object with ``init``, ``apply``, ``apply_stacked`` and
    ``num_params`` (the CNN, the MLP or the transformer classifier), or
    None to build ``fc.model``
    from the registry for ``fc.task``.  A mixed cohort
    (``fc.model_partition``) builds one classifier per architecture and
    takes model=None.  ``device``: where everything runs — the GPU by
    default; pass ``"cpu"`` to run on the CPU.
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
        self._arch_groups = fc.arch_groups()
        if self._arch_groups is not None:
            if model is not None:
                raise ValueError(
                    "mixed-architecture cohorts build their per-device "
                    "models from the registry; pass model=None")
            self.models = fc.build_models()
            model = self.models[fc.server_model()]
        elif model is None:
            model = fc.model_spec().build(fc.task_spec().input_shape,
                                          fc.num_classes)
        self.model = model
        self.ch = ch or ChannelConfig(num_devices=fc.num_devices)
        # one local train (so one captured step) per architecture group
        self.local_train = self._arch_trains = None
        if self._arch_groups is None:
            self.local_train = make_local_train(
                model.apply_stacked, fc.num_classes, fc.local_iters,
                fc.local_batch)
        else:
            self._arch_trains = [
                (arch, torch.as_tensor(idx, dtype=torch.int64,
                                       device=self.device),
                 make_local_train(self.models[arch].apply_stacked,
                                  fc.num_classes, fc.local_iters,
                                  fc.local_batch))
                for arch, idx in self._arch_groups]
        # the server model converts as a group of one (G = 1)
        self.output_to_model = OutputToModelSteps(model.apply)
        self._conv_consts = dict(
            iters=torch.full((1,), fc.server_iters, dtype=torch.int64,
                             device=self.device),
            eta=torch.full((1,), fc.eta, device=self.device),
            beta=torch.full((1,), fc.beta, device=self.device))
        self._codec = fc.codec_spec()
        self._uplink_stage = make_uplink_stage(self._codec, fc.protocol)
        self._plan_cache = {}
        # the sharded device axis: a ("data",) mesh over the round's
        # cohort, not the pool (only the cohort's rows are trained)
        self.mesh = None
        if fc.shard_devices:
            self.mesh = make_device_mesh(fc.cohort_size(),
                                         fc.mesh_shards or None,
                                         device=self.device)

    @property
    def local_trains(self) -> list:
        """The local trains of the cohort: one, or one per architecture
        group."""
        if self._arch_trains is None:
            return [self.local_train]
        return [lt for _, _, lt in self._arch_trains]

    @property
    def local_graphs(self) -> list:
        """The captured local steps (``core/graphs.py`` StepGraphs), one
        per input layout and architecture group."""
        return [g for lt in self.local_trains for g in lt.graphs]

    def init_state(self, num_devices: Optional[int] = None) -> RoundState:
        """Fresh :class:`RoundState`: the reference's key schedule (``key``
        is the second ``split(PRNGKey(seed))`` output) and a common init
        on every device.  In a mixed cohort the server's architecture
        shares the global init and every other one draws from
        ``fold_in(kinit, MODELS.index(arch) + 1)``."""
        fc = self.fc
        D = fc.num_devices if num_devices is None else num_devices
        C = fc.num_classes
        kinit, key = rng.split(rng.PRNGKey(fc.seed, self.device), 2)
        g_params = self.model.init(kinit)

        def stack(params, n):
            return {k: {m: t.expand((n,) + t.shape).clone()
                        for m, t in v.items()} for k, v in params.items()}

        if self._arch_groups is None:
            dev_params = stack(g_params, D)
        else:
            srv = fc.server_model()
            dev_params = {
                arch: stack(g_params if arch == srv else
                            self.models[arch].init(
                                rng.fold_in(kinit, MODELS.index(arch) + 1)),
                            len(idx))
                for arch, idx in self._arch_groups}
        gout = torch.full((C, C), 1.0 / C, device=self.device)
        dev_gout = gout.expand(D, C, C).clone()
        return RoundState(round=0, key=key, g_params=g_params,
                          dev_params=dev_params, gout=gout,
                          dev_gout=dev_gout)

    def link_plan(self, g_params, n_links: Optional[int] = None) -> LinkPlan:
        """The codec-aware link plan for an ``n_links``-device cohort
        (cached per cohort size)."""
        fc = self.fc
        n_links = fc.num_devices if n_links is None else n_links
        plan = self._plan_cache.get(n_links)
        if plan is None:
            plan = LinkPlan.build(fc.protocol, self.ch,
                                  n_mod=self.model.num_params(g_params),
                                  n_labels=fc.num_classes,
                                  sample_bits=fc.sample_bits,
                                  n_seed=fc.n_seed, codec=self._codec,
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

    def accuracy(self, params, x, y, model=None) -> float:
        with torch.no_grad():
            logits = (model or self.model).apply(params, x)
        return float((logits.argmax(-1) == y).to(torch.float32).mean())

    def _train(self, dev_params, dev_x, dev_y, dkeys, dev_gout, use_kd,
               n_local):
        """Local SGD of the round's devices; a mixed cohort trains each
        architecture group in its own parameter space (device d keeps
        its ``dkeys[d]``) and reassembles the (D, C, C) tables."""
        fc = self.fc
        if self.mesh is not None:
            return self._train_sharded(dev_params, dev_x, dev_y, dkeys,
                                       dev_gout, use_kd, n_local)
        if self._arch_trains is None:
            return self.local_train(dev_params, dev_x, dev_y, dkeys,
                                    dev_gout, use_kd, fc.eta, fc.beta,
                                    n_local)
        D, C = dev_x.shape[0], fc.num_classes
        favg = torch.zeros(D, C, C, device=self.device)
        cnt = torch.zeros(D, C, device=self.device)
        mloss = torch.zeros(D, device=self.device)
        new = {}
        for arch, idx, lt in self._arch_trains:
            new[arch], favg[idx], cnt[idx], mloss[idx] = lt(
                dev_params[arch], dev_x[idx], dev_y[idx], dkeys[idx],
                dev_gout[idx], use_kd, fc.eta, fc.beta, n_local)
        return new, favg, cnt, mloss

    def _train_sharded(self, dev_params, dev_x, dev_y, dkeys, dev_gout,
                       use_kd, n_local):
        """Local SGD of this rank's rows of the cohort (a captured step
        of D/S rows), then one all-gather of every rank's trained rows,
        tables and losses: the whole (D, ...) arrays on every rank."""
        fc, C = self.fc, self.fc.num_classes
        shards = GridShards(self.mesh, 1, dkeys.shape[0])
        trained = None      # a rank beyond the mesh trains nothing
        if shards.block is not None:
            sl = shards.block[1]
            new, favg, cnt, mloss = self.local_train(
                {k: {m: t[sl] for m, t in v.items()}
                 for k, v in dev_params.items()},
                dev_x[sl], dev_y[sl], dkeys[sl], dev_gout[sl], use_kd,
                fc.eta, fc.beta, n_local)
            trained = _leaves(new) + [favg, cnt, mloss]
        shapes = [t.shape[1:] for t in _leaves(dev_params)] + [
            (C, C), (C,), ()]
        *leaves, favg, cnt, mloss = [
            t[0] for t in shards.gather(trained, shapes, dev_gout)]
        return _rebuild(dev_params, leaves), favg, cnt, mloss

    def _convert(self, g_params, seeds, gout, key):
        """eq. (5): the K_s conversion steps of the server model, run as
        a group of one stacked model."""
        fc, c = self.fc, self._conv_consts
        new, _ = self.output_to_model(
            {k: {n: t[None] for n, t in v.items()}
             for k, v in g_params.items()},
            seeds["train_x"][None], seeds["train_y"][None], gout[None],
            rng.split(key, fc.server_iters)[None], c["iters"],
            seeds["train_x"].shape[0], fc.server_batch, c["eta"],
            c["beta"])
        return {k: {n: t[0] for n, t in v.items()} for k, v in new.items()}

    def round_once(self, state: RoundState, dev_x, dev_y, test_x, test_y,
                   *, plan: Optional[LinkPlan] = None, log=None,
                   _pending_link=None):
        """One federated round.  Returns ``(new_state, record)``.  The round
        number and every draw derive from ``state``; the tensors must lie
        on the trainer's device (``run`` moves them there).  ``dev_x`` and
        ``dev_y`` hold the device pool; with ``fc.sample_ratio < 1`` the
        round gathers its seeded cohort (``core/sampling.py``) off the
        pool, trains it, and scatters it back: devices outside the cohort
        keep their parameters and tables.

        ``_pending_link`` is a ``plan.dispatch`` handle of this round's
        link draw (the :class:`LoopRoundProgram` passes it), collected
        where the serial path would draw; it is dropped when the round
        rebuilds the plan for another cohort size.

        With ``shard_devices`` the rank trains its rows and the two
        aggregations reduce over the mesh; on a GPU the round runs under
        cuDNN's deterministic algorithms."""
        if self.mesh is None:
            return self._round(state, dev_x, dev_y, test_x, test_y, plan,
                               log, _pending_link)
        # every rank computes the replicated steps (the conversion above
        # all): deterministic algorithms keep the replicas equal
        with deterministic_cudnn(self.device):
            return self._round(state, dev_x, dev_y, test_x, test_y, plan,
                               log, _pending_link)

    def _round(self, state, dev_x, dev_y, test_x, test_y, plan, log,
               _pending_link):
        fc = self.fc
        proto = fc.protocol
        D_pool, n_local = dev_x.shape[:2]
        p = state.round + 1

        t0 = time.perf_counter()
        kr = rng.fold_in(state.key, p)
        use_kd = proto != "fl" and p > 1  # KD once G_out exists
        g_params, gout, seeds = state.g_params, state.gout, state.seeds
        dev_params, dev_gout = state.dev_params, state.dev_gout

        # ---- client sampling: gather the round's cohort off the pool ----
        D = fc.cohort_size(D_pool)
        cohort = None
        if D < D_pool:
            cohort = fc.sampler.cohort(fc.seed, p, D_pool)
            jdx = torch.as_tensor(cohort, device=self.device)
            dev_params = {k: {n: t[jdx] for n, t in v.items()}
                          for k, v in dev_params.items()}
            dev_gout, dev_x, dev_y = dev_gout[jdx], dev_x[jdx], dev_y[jdx]
        if plan is None or plan.n_links != D:
            plan = self.link_plan(g_params, n_links=D)
            _pending_link = None

        # ---- local updates (eq. 1 / 3) ----
        dkeys = rng.split(rng.fold_in(kr, 1), D)
        dev_params, favg, cnt, mloss = self._train(
            dev_params, dev_x, dev_y, dkeys, dev_gout, use_kd, n_local)
        self._sync()
        local_s = time.perf_counter() - t0

        # ---- seed collection (first round, FLD family) ----
        if p == 1 and proto in FLD_FAMILY:
            seeds = collect_seeds(fc, dev_x, dev_y, rng.fold_in(kr, 2))

        # ---- link pipeline: encode -> channel -> decode ----
        if _pending_link is not None:
            link = plan.collect(_pending_link)
        else:
            link = plan.draw(rng.fold_in(kr, 3), first_round=p == 1)
        up_ok, dn_ok = link["up_ok"], link["dn_ok"]
        ok = torch.as_tensor(up_ok, device=self.device)
        dev_params_rx, favg_rx = self._uplink_stage(
            dev_params, favg, rng.fold_in(kr, 5), dev_gout, g_params)

        # ---- aggregation + (FLD) conversion ----
        if proto == "fl":
            if up_ok.any():
                w = ok.to(torch.float32) * n_local   # |S_d| weights
                g_params = (weighted_avg(dev_params_rx, w)
                            if self.mesh is None else
                            weighted_avg_psum(dev_params_rx, w, self.mesh))
        else:
            if up_ok.any():
                okf = ok.to(torch.float32)
                gout = (gout_update(favg_rx, cnt, okf) if self.mesh is None
                        else gout_update_psum(favg_rx, cnt, okf, self.mesh))
            if proto != "fd":
                g_params = self._convert(g_params, seeds, gout,
                                         rng.fold_in(kr, 4))

        # ---- downlink (gated per device by dn_ok) ----
        mask = torch.as_tensor(dn_ok, device=self.device)
        dev_gout = downlink_gout(dev_gout, gout, mask)
        if proto != "fd":
            if self._arch_trains is None:
                dev_params = downlink_params(dev_params, g_params, mask)
            else:
                # the converted model lives in the server architecture's
                # space: only that group receives it, the others learn
                # through the tables
                srv = fc.server_model()
                dev_params = dict(dev_params)
                for arch, idx, _ in self._arch_trains:
                    if arch == srv:
                        dev_params[srv] = downlink_params(
                            dev_params[srv], g_params, mask[idx])

        # ---- scatter the trained cohort back into the pool ----
        if cohort is not None:
            dev_params = {k: {n: state.dev_params[k][n].index_copy(0, jdx, t)
                              for n, t in v.items()}
                          for k, v in dev_params.items()}
            dev_gout = state.dev_gout.index_copy(0, jdx, dev_gout)
        self._sync()
        compute_s = time.perf_counter() - t0
        cum_time = state.cum_time_s + compute_s + link["latency_s"]

        # ---- evaluation of the reference device: pool device 0 at full
        # participation, else the cohort's first device; in a mixed
        # cohort device 0 of the first architecture group ----
        if self._arch_trains is None:
            ref_dev = 0 if cohort is None else int(cohort[0])
            ref = {k: {n: t[ref_dev] for n, t in v.items()}
                   for k, v in dev_params.items()}
            acc = self.accuracy(ref, test_x, test_y)
        else:
            arch0 = self._arch_trains[0][0]
            ref = {k: {n: t[0] for n, t in v.items()}
                   for k, v in dev_params[arch0].items()}
            acc = self.accuracy(ref, test_x, test_y, self.models[arch0])
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
                  "uplink_ok": int(up_ok.sum()),
                  "n_straggle": int(link.get("n_straggle", 0)),
                  "n_active": D,
                  "cohort": cohort,  # None: every pool device trained
                  "link": link}
        return new_state, record

    def run(self, dev_x, dev_y, test_x, test_y, log=None,
            options: Optional[ProgramOptions] = None):
        """Full protocol run over ``fc.max_rounds`` rounds.  Data may be
        numpy arrays or tensors; it is moved to the trainer's device.
        Returns the history dict (per-round accuracy, losses, latency,
        cumulative time, seed metadata; with the ``dp_gaussian`` codec
        the epsilon after each round and the accountant's ledger; the
        dispatch window's stats under ``pipeline``).  ``options`` sets
        the link-draw pipeline's depth (default 1); every depth gives
        the same history."""
        fc = self.fc
        spec = self._codec
        dev_x, test_x = (self._tensor(a, torch.float32)
                         for a in (dev_x, test_x))
        dev_y, test_y = (self._tensor(a, torch.int64)
                         for a in (dev_y, test_y))
        pool = dev_x.shape[0]
        state = self.init_state(pool)
        plan = self.link_plan(state.g_params, n_links=fc.cohort_size(pool))
        acct = (GaussianAccountant(spec.dp_sigma, spec.dp_delta,
                                   sample_ratio=fc.sample_ratio)
                if spec.name == "dp_gaussian" else None)
        history = {"acc": [], "round_latency_s": [], "compute_s": [],
                   "local_s": [], "cum_time_s": [], "loss": [], "uplink_ok": [],
                   "converged_round": None, "protocol": fc.protocol,
                   "model": fc.model_key(), "task": fc.task,
                   "codec": spec.name, "sample_ratio": fc.sample_ratio,
                   "cohort_size": fc.cohort_size(pool),
                   "uplink_bits_first": plan.up_bits_first,
                   "uplink_bits": plan.up_bits,
                   "downlink_bits": plan.dn_bits,
                   "device": str(self.device)}
        if acct is not None:
            history["dp_epsilon"] = []
        program = LoopRoundProgram(self, options).bind(
            dev_x=dev_x, dev_y=dev_y, test_x=test_x, test_y=test_y,
            plan=plan, log=log)
        for _ in range(fc.max_rounds):
            state, rec = program.step(state)
            if acct is not None:
                # a device spends budget only on rounds it released a
                # noised payload: its cohort rounds
                acct.step(cohort=rec["cohort"])
                history["dp_epsilon"].append(acct.epsilon())
            for k in ("acc", "loss", "round_latency_s", "compute_s",
                      "local_s", "cum_time_s", "uplink_ok"):
                history[k].append(rec[k])
        history["pipeline"] = program.finalize()
        history["converged_round"] = state.converged_round
        history["seeds"] = summarize_seeds(state.seeds)
        if acct is not None:
            history["dp"] = acct.ledger()
        if fc.keep_seed_arrays:
            history["seed_arrays"] = state.seeds
        history["final_acc"] = history["acc"][-1]
        self.last_dev_gout = state.dev_gout
        return history


# ---------------------------------------------------------------------------
# The sweep grid's round step: a group of G points, stacked
# ---------------------------------------------------------------------------

def _rows_of(tree):
    """Leaves (G, n, ...) -> (G n, ...) views."""
    return {k: {m: t.reshape((-1,) + tuple(t.shape[2:]))
                for m, t in v.items()} for k, v in tree.items()}


def _points_of(tree, n: int):
    """Leaves (G n, ...) -> (G, n, ...) views."""
    return {k: {m: t.reshape((-1, n) + tuple(t.shape[1:]))
                for m, t in v.items()} for k, v in tree.items()}


def _take(tree, g, idx):
    """Leaves (G, D, ...) gathered at (G, n) device indices."""
    return {k: {m: t[g, idx] for m, t in v.items()}
            for k, v in tree.items()}


def _put(pool, g, idx, tree):
    """``pool`` leaves (G, D, ...) with the (G, n) rows ``idx`` replaced by
    ``tree``'s, as new tensors."""
    out = {}
    for k, v in tree.items():
        out[k] = {}
        for m, t in v.items():
            leaf = pool[k][m].clone()
            leaf[g, idx] = t
            out[k][m] = leaf
    return out


def _where_points(mask, new, old):
    """Per point (G,) ``new`` where ``mask`` else ``old``, leaf by leaf."""
    return {k: {m: torch.where(mask.reshape((-1,) + (1,) * (t.dim() - 1)),
                               t, old[k][m]) for m, t in v.items()}
            for k, v in new.items()}


class ArchTrain(NamedTuple):
    """One architecture group of a sweep group's cohort: its name (None
    for a homogeneous cohort), its device indices (None: all), its
    :class:`LocalTrain`, its model, and eta, beta and n_local per device
    row of the group."""
    arch: Optional[str]
    idx: Optional[torch.Tensor]
    train: LocalTrain
    model: object
    rows: dict


def grid_weighted_avg(stacked, w):
    """:func:`weighted_avg` of each point of a group: leaves (G, D, ...)
    and weights (G, D) -> leaves (G, ...)."""
    G, D = w.shape
    wsum = w.sum(1).clamp_min(1e-9)
    return {k: {m: (torch.bmm(w[:, None], t.reshape(G, D, -1))
                    .reshape((G,) + tuple(t.shape[2:]))
                    / wsum.reshape((-1,) + (1,) * (t.dim() - 2)))
                for m, t in v.items()} for k, v in stacked.items()}


def grid_gout_update(favg, cnt, ok):
    """:func:`gout_update` of each point: (G, D, C, C), (G, D, C), (G, D)
    -> (G, C, C)."""
    cw = ok[..., None] * cnt                             # (G, D, C)
    num = torch.einsum("gdc,gdcm->gcm", cw, favg)
    return num / cw.sum(1)[..., None].clamp_min(1.0)


class GridShards:
    """A sweep group's three device-axis functions on a ("data",) or
    ("grid", "data") mesh (``launch/mesh.py``), in place of the
    :class:`GridRoundStep`'s defaults: the sharded forms the reference's
    sweep engine ``shard_map``s.  At G = 1 on a ("data",) mesh it splits
    the trainer's device axis (``shard_devices``).

    A rank at mesh coordinate (gi, di) owns the points of grid block gi
    and the device rows of data block di.  ``local_train`` trains that
    block and gathers every rank's block (one all-gather), so the rest of
    the round sees the whole (G, D, ...) arrays on every rank.
    ``weighted_avg`` and ``gout_update`` sum over the block's rows (the
    rest weigh zero, so the sums run the unsharded kernels on their
    shapes), then all-reduce once: a point's sum adds only the partial
    sums of its own grid block's data ranks (the reduction stays over
    "data"; every other rank adds exact zeros).  A rank beyond the mesh
    owns nothing and adds zeros."""

    def __init__(self, mesh, G: int, D: int):
        shape = tuple(mesh.shape)
        self.gs, self.ds = (1,) * (2 - len(shape)) + shape
        if G % self.gs or D % self.ds:
            raise ValueError(f"a ({G}, {D}) group does not split over a "
                             f"{self.gs}x{self.ds} mesh")
        self.gb, self.db = G // self.gs, D // self.ds
        c = mesh_coordinate(mesh)
        self.block = None
        if c is not None:
            gi, di = (0,) * (2 - len(c)) + c
            self.block = (slice(gi * self.gb, (gi + 1) * self.gb),
                          slice(di * self.db, (di + 1) * self.db))

    def gather(self, tensors, shapes, like):
        """Every rank's block — ``tensors``, float32 with the block's
        ``gb x db`` rows leading (None on a rank beyond the mesh) — as
        whole (G, D, *shape) tensors of ``shapes`` on every rank: one
        all-gather."""
        n = self.gb * self.db
        if tensors is None:
            block = like.new_zeros(n, sum(int(np.prod(s)) for s in shapes))
        else:
            block = _pack(tensors, n)
        g = all_gather_rows(block)[:self.gs * self.ds]
        g = g.reshape(self.gs, self.ds, self.gb, self.db, -1)
        G, D = self.gs * self.gb, self.ds * self.db
        return _split(g.permute(0, 2, 1, 3, 4).reshape(G, D, -1), shapes,
                      (G, D))

    def mask(self, like):
        """(G, D) ones on this rank's block, zeros elsewhere: the sums run
        the unsharded kernels on their shapes, the other ranks' rows
        weighing zero (``x + 0.0`` and ``0.0 * x`` are exact)."""
        mask = like.new_zeros(self.gs * self.gb, self.ds * self.db)
        if self.block is not None:
            mask[self.block] = 1.0
        return mask

    def local_train(self, train, dev_params, dev_gout, rows, dkeys, use_kd):
        """``train`` is the step's block trainer (:meth:`GridRoundStep.
        _train`)."""
        C = dev_gout.shape[-1]
        trained = None
        if self.block is not None:
            new, favg, cnt, mloss = train(dev_params, dev_gout, rows, dkeys,
                                          use_kd, self.block)
            trained = _leaves(new) + [favg, cnt, mloss]
        shapes = [t.shape[2:] for t in _leaves(dev_params)] + [
            (C, C), (C,), ()]
        *leaves, favg, cnt, mloss = self.gather(trained, shapes, dev_gout)
        return _rebuild(dev_params, leaves), favg, cnt, mloss

    def weighted_avg(self, stacked, w, dot=_bmm):
        """The weighted model average over the device axis (the last of
        ``w``: (D,) for the trainer, (G, D) for a sweep group): ``dot``,
        the unsharded path's weighted sum (:func:`weighted_avg`'s
        tensordot, :func:`grid_weighted_avg`'s bmm), and the weight sum
        over this block's rows, then one all-reduce."""
        lead = tuple(w.shape[:-1])
        w = w * self.mask(w).reshape(w.shape)
        leaves = _leaves(stacked)
        shapes = [t.shape[w.dim():] for t in leaves]
        flat = all_reduce_sum(torch.cat(
            [w.sum(-1)[..., None]] +
            [dot(w, t).reshape(lead + (-1,)) for t in leaves], -1))
        wsum = flat[..., 0].clamp_min(1e-9)
        return _rebuild(stacked, [
            t / wsum.reshape(lead + (1,) * len(s))
            for t, s in zip(_split(flat[..., 1:], shapes, lead), shapes)])

    def gout_update(self, favg, cnt, ok, subscripts="gdc,gdcm->gcm"):
        """eq. (2) over the device axis: the numerator (the unsharded
        path's einsum ``subscripts``) and denominator over this block's
        rows, then one all-reduce."""
        lead, C = tuple(cnt.shape[:-2]), favg.shape[-1]
        cw = ok[..., None] * cnt * self.mask(cnt).reshape(
            cnt.shape[:-1])[..., None]
        flat = all_reduce_sum(torch.cat(
            [torch.einsum(subscripts, cw, favg).reshape(lead + (-1,)),
             cw.sum(-2)], -1))
        num = flat[..., :C * C].reshape(lead + (C, C))
        return num / flat[..., C * C:][..., None].clamp_min(1.0)


class GridRoundStep:
    """:func:`make_grid_round_step`'s callable: ``step(state, xs) ->
    (state, out)`` for one round of a sweep group.

    ``local_trains`` holds an :class:`ArchTrain` (one, or one per
    architecture group of a mixed cohort) and ``conversion`` the
    :class:`OutputToModelSteps` of the FLD family (else None): each
    keeps one captured step for the group.  ``local_train_fn``,
    ``weighted_avg_fn`` and ``gout_update_fn`` replace the device-axis
    functions (the sweep engine passes a :class:`GridShards`'s on a
    mesh); the defaults are the step's own block trainer over every
    row, :func:`grid_weighted_avg` and :func:`grid_gout_update`."""

    def __init__(self, model, *, protocol: str, num_devices: int,
                 num_classes: int, local_iters: int, local_batch: int,
                 server_batch: int, t_max_slots: int, tau_s: float,
                 dev_x, dev_y, data_rows, test_x, test_y, consts: dict,
                 codec="identity", cohort_size: Optional[int] = None,
                 arch_groups: Optional[list] = None,
                 local_train_fn=None, weighted_avg_fn=None,
                 gout_update_fn=None):
        proto = canonical_protocol(protocol)
        D, C = num_devices, num_classes
        Dc = D if cohort_size is None else min(int(cohort_size), D)
        self.sampled = Dc < D
        if arch_groups is not None:
            if self.sampled:
                raise ValueError("mixed-architecture grid programs require "
                                 "full participation")
            if proto == "fl":
                raise ValueError("protocol 'fl' cannot mix architectures")
        self.proto, self.Dc, self.C = proto, Dc, C
        self.server_batch = server_batch
        self.t_max_slots, self.tau_s = t_max_slots, tau_s
        self.dev_x, self.dev_y, self.data_rows = dev_x, dev_y, data_rows
        self.test_x, self.test_y = test_x, test_y
        self.consts = consts
        self.spec = parse_codec(codec)
        G = consts["key"].shape[0]
        dev = consts["key"].device
        self.G, self.points = G, torch.arange(G, device=dev)[:, None]

        def per_row(name, n):
            return consts[name][:, None].expand(G, n).reshape(-1)

        groups = (arch_groups if arch_groups is not None
                  else [(None, None, model)])
        self.local_trains = []
        for arch, idx, m in groups:
            n = Dc if idx is None else len(idx)
            ji = None if idx is None else torch.as_tensor(
                np.asarray(idx), dtype=torch.int64, device=dev)
            lt = make_local_train(m.apply_stacked, C, local_iters,
                                  local_batch)
            self.local_trains.append(ArchTrain(
                arch, ji, lt, m,
                {k: per_row(k, n) for k in ("eta", "beta", "n_local")}))
        self.codec_rows = (None if self.spec.name == "identity" else
                           {k: per_row(k, Dc)
                            for k in ("levels", "noise", "clip")})
        self.conversion = (OutputToModelSteps(model.apply)
                           if proto in FLD_FAMILY else None)
        self.mixed = arch_groups is not None
        self.ref_model = groups[0][2]
        if self.mixed and local_train_fn is not None:
            raise ValueError(
                "mixed-architecture cohorts are not supported on the "
                "mesh-sharded path: per-device parameter pytrees differ "
                "across shards")
        self.local_train_fn = local_train_fn
        self.weighted_avg_fn = weighted_avg_fn or grid_weighted_avg
        self.gout_update_fn = gout_update_fn or grid_gout_update

    def _train(self, dev_params, dev_gout, rows, dkeys, use_kd, block=None):
        """Local SGD of every point's cohort, or with ``block`` (a slice
        of the points, a slice of the devices) of that block's rows only:
        (params, favg, cnt, mloss) in the (G, n, ...) layout of the
        block."""
        G, Dc, C = self.G, self.Dc, self.C
        if not self.mixed:
            at = self.local_trains[0]
            pts = dvs = slice(None)
            rw = {k: at.rows[k] for k in ("eta", "beta", "n_local")}
            if block is not None:
                pts, dvs = block
                dev_params = {k: {m: t[pts, dvs] for m, t in v.items()}
                              for k, v in dev_params.items()}
                dev_gout, rows, dkeys = (dev_gout[pts, dvs], rows[pts, dvs],
                                         dkeys[pts, dvs])
                rw = {k: r.view(G, Dc)[pts, dvs].reshape(-1)
                      for k, r in rw.items()}
            Gb, n = dkeys.shape[:2]
            new, favg, cnt, mloss = at.train(
                _rows_of(dev_params), self.dev_x, self.dev_y,
                dkeys.reshape(-1, 2), dev_gout.reshape(-1, C, C), use_kd,
                rw["eta"], rw["beta"], rw["n_local"],
                rows=rows.reshape(-1))
            return (_points_of(new, n), favg.view(Gb, n, C, C),
                    cnt.view(Gb, n, C), mloss.view(Gb, n))
        dev = dev_gout.device
        favg = torch.zeros(G, Dc, C, C, device=dev)
        cnt = torch.zeros(G, Dc, C, device=dev)
        mloss = torch.zeros(G, Dc, device=dev)
        new = {}
        for arch, ji, lt, _, r in self.local_trains:
            n = ji.shape[0]
            p_a, f_a, c_a, l_a = lt(
                _rows_of(dev_params[arch]), self.dev_x, self.dev_y,
                dkeys[:, ji].reshape(-1, 2),
                dev_gout[:, ji].reshape(-1, C, C), use_kd, r["eta"],
                r["beta"], r["n_local"], rows=rows[:, ji].reshape(-1))
            new[arch] = _points_of(p_a, n)
            favg.index_copy_(1, ji, f_a.view(G, n, C, C))
            cnt.index_copy_(1, ji, c_a.view(G, n, C))
            mloss.index_copy_(1, ji, l_a.view(G, n))
        return new, favg, cnt, mloss

    def __call__(self, state: RoundState, xs: dict):
        proto, consts, G, Dc, C = (self.proto, self.consts, self.G,
                                   self.Dc, self.C)
        p = xs["p"]
        kr = rng.fold_in(consts["key"], p)                   # (G, 2)
        use_kd = proto != "fl" and p > 1

        # ---- client sampling: gather each point's cohort off the pool
        pool_params, pool_gout = state.dev_params, state.dev_gout
        rows = self.data_rows                                # (G, D)
        if self.sampled:
            chrt = xs["cohort"]                              # (G, Dc)
            dev_params = _take(pool_params, self.points, chrt)
            dev_gout = pool_gout[self.points, chrt]
            rows = rows[self.points, chrt]
        else:
            dev_params, dev_gout = pool_params, pool_gout

        # ---- local updates (eq. 1 / 3): one captured step a group ----
        dkeys = rng.split(rng.fold_in(kr, 1), Dc)            # (G, Dc, 2)
        if self.local_train_fn is None:
            dev_params, favg, cnt, mloss = self._train(
                dev_params, dev_gout, rows, dkeys, use_kd)
        else:
            dev_params, favg, cnt, mloss = self.local_train_fn(
                self._train, dev_params, dev_gout, rows, dkeys, use_kd)

        # ---- channel: every point's draw at once ----
        link = round_trip_traced(rng.fold_in(kr, 3), consts["p_up"],
                                 xs["up_slots"], consts["p_dn"],
                                 xs["dn_slots"], Dc, self.t_max_slots,
                                 self.tau_s)
        up_ok, dn_ok = link["up_ok"], link["dn_ok"]          # (G, Dc)
        any_up = up_ok.any(1)
        okf = up_ok.to(torch.float32)

        # ---- uplink codec (identity skips the stage) ----
        dev_params_rx, favg_rx = dev_params, favg
        if self.codec_rows is not None:
            p_rx, f_rx = grid_uplink_stage(
                self.spec, proto,
                _rows_of(dev_params) if proto == "fl" else None,
                favg.reshape(-1, C, C), rng.fold_in(kr, 5),
                dev_gout.reshape(-1, C, C), state.g_params,
                self.codec_rows)
            if proto == "fl":
                dev_params_rx = _points_of(p_rx, Dc)
            favg_rx = f_rx.view(G, Dc, C, C)

        # ---- aggregation + (FLD) conversion, gated per point ----
        g_params, gout = state.g_params, state.gout
        if proto == "fl":
            w = okf * consts["n_local"].to(torch.float32)[:, None]
            new_g = self.weighted_avg_fn(dev_params_rx, w)
            g_params = _where_points(any_up, new_g, g_params)
        else:
            new_gout = self.gout_update_fn(favg_rx, cnt, okf)
            gout = torch.where(any_up[:, None, None], new_gout, gout)
            if proto != "fd":
                g_params, _ = self.conversion(
                    g_params, consts["seeds_x"], consts["seeds_y"], gout,
                    xs["conv_keys"], consts["s_iters"], consts["n_train"],
                    self.server_batch, consts["eta"], consts["beta"])

        # ---- downlink (gated per device by dn_ok) ----
        dev_gout = downlink_gout(dev_gout, gout, dn_ok)
        if proto != "fd":
            if not self.mixed:
                dev_params = downlink_params(dev_params, g_params, dn_ok)
            else:
                # the converted model is the server architecture's: only
                # its group (the first) receives it
                a0, i0 = self.local_trains[0].arch, self.local_trains[0].idx
                dev_params = dict(dev_params)
                dev_params[a0] = downlink_params(dev_params[a0], g_params,
                                                 dn_ok[:, i0])

        # ---- scatter the trained cohorts back into the pools ----
        if self.sampled:
            dev_params = _put(pool_params, self.points, chrt, dev_params)
            cohort_gout, dev_gout = dev_gout, pool_gout.clone()
            dev_gout[self.points, chrt] = cohort_gout

        # ---- evaluation of each point's reference device: device 0, or
        # the cohort's first under sampling ----
        if self.sampled:
            ref = {k: {m: t[self.points[:, 0], chrt[:, 0]]
                       for m, t in v.items()} for k, v in dev_params.items()}
        elif self.mixed:
            ref = {k: {m: t[:, 0] for m, t in v.items()}
                   for k, v in dev_params[self.local_trains[0].arch].items()}
        else:
            ref = {k: {m: t[:, 0] for m, t in v.items()}
                   for k, v in dev_params.items()}
        with torch.no_grad():   # each point's model alone, as its loop's
            logits = torch.stack([self.ref_model.apply(
                {k: {m: t[g] for m, t in v.items()} for k, v in ref.items()},
                self.test_x) for g in range(G)])
        acc = (logits.argmax(-1) == self.test_y).to(torch.float32).mean(1)

        # ---- convergence: the first round with rel < eps, some uplink
        # decoded and the round past the first ----
        if proto == "fd":
            flat = gout.reshape(G, -1)
        else:
            flat = torch.cat([t.reshape(G, -1) for v in g_params.values()
                              for t in v.values()], 1)
        converged = state.converged_round
        if p >= 2:
            rel = (torch.linalg.vector_norm(flat - state.prev, dim=1)
                   / torch.linalg.vector_norm(state.prev, dim=1)
                   .clamp_min(1e-12))
            hit = (rel.to(torch.float64) < consts["eps"]) & any_up & \
                (converged == 0)
            converged = torch.where(hit, p, converged)

        out = {"acc": acc, "loss": mloss.mean(1),
               "latency_s": link["latency_s"],
               "up_ok": up_ok.sum(1)}
        return state.replace(dev_params=dev_params, g_params=g_params,
                             gout=gout, dev_gout=dev_gout, prev=flat,
                             converged_round=converged), out


def make_grid_round_step(model, **kw) -> GridRoundStep:
    """The sweep grid's round step for one program group: G points of
    one (protocol, codec family, cohort size, model, task), stacked —
    ``FederatedTrainer.round_once``'s body with every host decision
    (success gating, convergence) as masked tensor operations, so a
    round issues its work without reading anything back.

    ``model`` has ``apply_stacked``; with ``arch_groups`` (a mixed
    cohort: ``[(name, device indices, model), ...]``, device 0's group
    first, the server's) each architecture group trains its own stack.
    ``dev_x`` (N, n, ...) and ``dev_y`` (N, n) hold the group's distinct
    partitions, ``data_rows`` (G, D) point g's device d's row of them.
    ``consts`` holds tensors with a leading G axis: ``key`` (G, 2) (each
    point's run key, the second output of ``split(PRNGKey(seed))``),
    ``eta``, ``beta``, ``p_up``, ``p_dn`` float32, ``eps`` float64,
    ``n_local``, ``s_iters``, ``n_train`` int64, the padded seed sets
    ``seeds_x``/``seeds_y``, and for a codec other than identity its
    ``levels``, ``noise`` and ``clip``.  A round's ``xs``: ``p`` (int),
    ``up_slots``/``dn_slots`` (G,), ``conv_keys`` (G, K_max, 2) and,
    sampled, ``cohort`` (G, Dc).

    ``local_train_fn``, ``weighted_avg_fn`` and ``gout_update_fn`` (a
    :class:`GridShards`'s, on a mesh) replace the step's device-axis
    functions, as the reference's hooks do.

    State: a :class:`RoundState` with ``dev_params`` leaves (G, D, ...)
    (per architecture in a mixed cohort), ``g_params`` (G, ...), ``gout``
    (G, C, C), ``dev_gout`` (G, D, C, C), ``prev`` (G, P) and
    ``converged_round`` (G,) int64, 0 for not yet."""
    return GridRoundStep(model, **kw)
