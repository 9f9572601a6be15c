"""Payload codecs and per-protocol payload accounting (Sec. II-C / III-A).

Uncoded payloads:

FL : B_up = B_dn = b_mod * N_mod
FD : B_up = B_dn = b_out * N_L^2
FLD-family: B_up = b_out * N_L^2 (+ b_s * N_s on the first round),
            B_dn = b_mod * N_mod

Codecs transform what the recurring uplink carries (soft-label tables
for the FD/FLD family, model parameters for FL):

``identity``            the raw payload, untouched
``quantize{bits}``      stochastic rounding to ``2^bits - 1`` levels; the
                        uplink element width drops from 32 to ``bits``
``delta``               the payload minus the receiver-tracked reference
``dp_gaussian{sigma}``  clip + Gaussian noise (``core/privacy.py``)

The first-round seed samples and the downlink stay uncoded.

The codec functions work on a device-stacked payload: tables (D, C, C)
and parameter leaves (D, ...), with one key per device (D, 2) — the
reference's ``vmap`` over devices.  ``rows`` optionally gives each row its
own numeric parameters, ``{"levels", "noise", "clip"}`` tensors of one
value a row (a sweep group's points, each with its own ``quant_bits``,
``dp_sigma`` and ``dp_clip``; ``noise`` is ``dp_sigma * dp_clip``,
multiplied on the host as the loop path multiplies its floats).  The
random draws follow the
reference's: a parameter tree's leaves take ``fold_in(key, i)`` in
``jax.tree.flatten`` order (dict keys sorted) and draw in the
reference's leaf shape.  The port keeps the CNN's conv weights OIHW
where the reference keeps them HWIO (``models/cnn.py``), so a draw for a
4-D leaf is made HWIO and permuted.
"""
from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple

import torch

from .. import rng
from ..core.privacy import clip_scale, gaussian_epsilon, gaussian_mechanism
from ..registry import FLD_FAMILY, canonical_protocol

B_MOD = 32  # bits per weight
B_OUT = 32  # bits per output element

#: Registered codec family names.
CODECS = ("identity", "quantize", "delta", "dp_gaussian")

_CODEC_RE = re.compile(r"^(?P<name>[a-z_]+?)(?P<param>\d+(?:\.\d+)?)?$")


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """One resolved link codec: family name + numeric parameters."""
    name: str = "identity"
    quant_bits: int = 8
    dp_sigma: float = 1.0
    dp_clip: float = 1.0
    dp_delta: float = 1e-5

    def __post_init__(self):
        if self.name not in CODECS:
            raise ValueError(
                f"unknown codec {self.name!r}; one of {CODECS} "
                f"(parameterized: 'quantize8', 'dp_gaussian0.5')")
        if self.name == "quantize" and not 1 <= self.quant_bits <= 32:
            raise ValueError(
                f"quantize bits must be in [1, 32], got {self.quant_bits}")
        if self.name == "dp_gaussian":
            gaussian_epsilon(self.dp_sigma, self.dp_delta, 1)

    @property
    def levels(self) -> float:
        """Quantization grid resolution (``2^bits - 1`` steps on [0, 1])."""
        return float(2 ** self.quant_bits - 1)

    def element_bits(self, base_bits: int) -> int:
        """Bit width of one encoded payload element (``base_bits``: the
        uncoded width)."""
        return self.quant_bits if self.name == "quantize" else base_bits


def parse_codec(spec, *, quant_bits: int = 8, dp_sigma: float = 1.0,
                dp_clip: float = 1.0, dp_delta: float = 1e-5) -> CodecSpec:
    """Resolve a :class:`CodecSpec`, a family name (``"quantize"``) or a
    parameterized string (``"quantize8"``, ``"dp_gaussian0.5"``) whose
    suffix overrides that family's keyword default."""
    if isinstance(spec, CodecSpec):
        return spec
    m = _CODEC_RE.match(str(spec))
    name = m.group("name") if m else str(spec)
    param = m.group("param") if m else None
    if name not in CODECS:
        return CodecSpec(name=str(spec))   # raises the shared message
    if param is not None:
        if name == "quantize":
            quant_bits = int(param)
        elif name == "dp_gaussian":
            dp_sigma = float(param)
        else:
            raise ValueError(
                f"codec {name!r} takes no numeric parameter "
                f"(got {spec!r})")
    return CodecSpec(name=name, quant_bits=quant_bits, dp_sigma=dp_sigma,
                     dp_clip=dp_clip, dp_delta=dp_delta)


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    """The link-codec half of a federated config, as a typed sub-config
    (``FederatedConfig.channel``), validated once at construction.  The
    physical channel is ``channel.ChannelConfig``."""
    codec: str = "identity"
    quant_bits: int = 8
    dp_sigma: float = 1.0
    dp_clip: float = 1.0
    dp_delta: float = 1e-5

    def __post_init__(self):
        self.spec()

    def spec(self) -> CodecSpec:
        return parse_codec(self.codec, quant_bits=self.quant_bits,
                           dp_sigma=self.dp_sigma, dp_clip=self.dp_clip,
                           dp_delta=self.dp_delta)


# ---------------------------------------------------------------------------
# The codec transforms, device-stacked
# ---------------------------------------------------------------------------

def _per_row(x):
    """Reduction dims of a device-stacked (D, ...) tensor."""
    return tuple(range(1, x.dim()))


def stochastic_round(x, u, levels):
    """Unbiased stochastic rounding of ``x`` in [0, 1] onto ``levels + 1``
    grid points, with the uniforms ``u`` (x's shape) drawn by the
    caller."""
    return torch.clamp(torch.floor(x * levels + u) / levels, 0.0, 1.0)


def quantize_affine(x, u, levels):
    """Stochastic rounding of a device-stacked (D, ...) array, each row
    rescaled to [0, 1] by its own (min, max)."""
    dims = _per_row(x)
    lo = x.amin(dims, keepdim=True)
    hi = x.amax(dims, keepdim=True)
    scale = (hi - lo).clamp_min(1e-12)
    return lo + stochastic_round((x - lo) / scale, u, levels) * scale


def _draw(fn, key, like):
    """``fn(key, shape)`` for a device-stacked leaf ``like`` (D, ...) with
    keys (D, 2), in the reference's leaf shape: a 4-D conv weight is
    drawn HWIO and permuted to the port's OIHW."""
    shape = tuple(like.shape[1:])
    if len(shape) != 4:
        return fn(key, shape)
    o, i, h, w = shape
    return fn(key, (h, w, i, o)).permute(0, 4, 3, 1, 2)


def _ref_leaves(params):
    """(group, name) of each leaf in ``jax.tree.flatten`` order."""
    return [(k, n) for k in sorted(params) for n in sorted(params[k])]


def _map(params, fn):
    return {k: {n: fn(k, n, t) for n, t in v.items()}
            for k, v in params.items()}


def _numeric(spec: CodecSpec, rows, like):
    """(levels, noise, clip): the spec's floats, or ``rows``'s per-row
    tensors shaped to broadcast over ``like`` (D, ...)."""
    if rows is None:
        return spec.levels, spec.dp_sigma * spec.dp_clip, spec.dp_clip
    shape = (-1,) + (1,) * (like.dim() - 1)
    return tuple(rows[n].reshape(shape) for n in ("levels", "noise", "clip"))


def encode_table(spec: CodecSpec, table, key, ref, rows=None):
    """Encode every device's soft-label table: ``table`` (D, C, C), keys
    (D, 2), ``ref`` (D, C, C) each device's receiver-tracked previous
    global average (its ``dev_gout`` copy)."""
    if spec.name == "identity":
        return table
    levels, noise, clip = _numeric(spec, rows, table)
    if spec.name == "quantize":
        u = rng.uniform(key, tuple(table.shape[1:]))
        return stochastic_round(table, u, levels)
    if spec.name == "delta":
        return table - ref
    return gaussian_mechanism(table, key, noise, clip)


def decode_table(spec: CodecSpec, coded, ref):
    """Receiver half for soft-label tables (delta adds the reference
    back; the lossy codecs decode as they are)."""
    return coded + ref if spec.name == "delta" else coded


def encode_params(spec: CodecSpec, params, key, ref, rows=None):
    """Encode every device's model parameters (FL uplink): ``params``
    leaves (D, ...), keys (D, 2), ``ref`` the round's starting global
    model (leaves without the device axis, or with it: one a device)."""
    if spec.name == "identity":
        return params
    if spec.name == "delta":
        return _map(params, lambda k, n, t: t - ref[k][n])
    order = {leaf: i for i, leaf in enumerate(_ref_leaves(params))}
    keys = {leaf: rng.fold_in(key, i) for leaf, i in order.items()}
    if spec.name == "quantize":
        return _map(params, lambda k, n, t: quantize_affine(
            t, _draw(rng.uniform, keys[k, n], t),
            _numeric(spec, rows, t)[0]))
    # dp_gaussian: the clip bounds each device's global norm over its
    # leaves, summed in the reference's leaf order
    sq = None
    for k, n in order:
        t = params[k][n]
        s = (t * t).sum(_per_row(t))
        sq = s if sq is None else sq + s
    scale = clip_scale(sq, _numeric(spec, rows, sq)[2])
    return _map(params, lambda k, n, t: (
        t * scale.reshape((-1,) + (1,) * (t.dim() - 1))
        + _numeric(spec, rows, t)[1] * _draw(rng.normal, keys[k, n], t)))


def decode_params(spec: CodecSpec, coded, ref):
    if spec.name == "delta":
        return _map(coded, lambda k, n, t: t + ref[k][n])
    return coded


# ---------------------------------------------------------------------------
# Codec-aware bit accounting
# ---------------------------------------------------------------------------

class RoundPayload(NamedTuple):
    """Per-device payload bits: first-round uplink, steady uplink,
    downlink."""
    up_first: float
    up_steady: float
    dn: float


def round_payload_bits(protocol: str, *, n_mod: int, n_labels: int,
                       sample_bits: int = 0, n_seed: int = 0,
                       codec="identity") -> RoundPayload:
    """Per-device bits for one (protocol, codec) point."""
    proto = canonical_protocol(protocol)
    spec = parse_codec(codec)
    out_bits = spec.element_bits(B_OUT) * n_labels * n_labels
    mod_bits = B_MOD * n_mod
    if proto == "fl":
        up = spec.element_bits(B_MOD) * n_mod
        return RoundPayload(up, up, mod_bits)
    if proto == "fd":
        # uplink-only codec: the downlink broadcast of G_out stays raw
        return RoundPayload(out_bits, out_bits,
                            B_OUT * n_labels * n_labels)
    assert proto in FLD_FAMILY
    # round-1 seed samples ride along raw with the first table upload
    return RoundPayload(out_bits + sample_bits * n_seed, out_bits,
                        mod_bits)


def round_slot_plan(protocol: str, cfg, *, n_mod: int, n_labels: int,
                    sample_bits: int = 0, n_seed: int = 0,
                    codec="identity") -> dict:
    """Per-slot success probabilities, decode-slot requirements and the
    payload bits they came from, for one (protocol, codec, channel)
    point."""
    from .model import slots_needed

    p_up, bits_up = cfg.link_budget(True)
    p_dn, bits_dn = cfg.link_budget(False)
    pay = round_payload_bits(protocol, n_mod=n_mod, n_labels=n_labels,
                             sample_bits=sample_bits, n_seed=n_seed,
                             codec=codec)
    return {"p_up": p_up, "p_dn": p_dn,
            "up_slots_first": slots_needed(pay.up_first, bits_up),
            "up_slots": slots_needed(pay.up_steady, bits_up),
            "dn_slots": slots_needed(pay.dn, bits_dn),
            "up_bits_first": pay.up_first, "up_bits": pay.up_steady,
            "dn_bits": pay.dn}
