"""The link pipeline: every device<->server transfer as one seam,
``encode -> channel -> decode``.

* :func:`uplink_stage` / :func:`make_uplink_stage` — the uplink codec
  stage (``channel/payload.py``): what the server decodes of each
  device's payload;
* :class:`LinkPlan` — the host-side link plan (per-slot success
  probabilities and decode-slot counts) and its per-round draw;
* :func:`downlink_gout` / :func:`downlink_params` — the downlink
  broadcast, gated per device by ``dn_ok``.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import rng
from ..registry import canonical_protocol
from .model import round_trip_traced
from .payload import (CodecSpec, decode_params, decode_table, encode_params,
                      encode_table, parse_codec, round_slot_plan)


@dataclasses.dataclass(frozen=True)
class LinkPlan:
    """Host-side link plan of one (protocol, codec, channel) point.
    ``n_links`` is the cohort on air this round; the FDMA bandwidth split
    stays at ``ChannelConfig.num_devices``."""
    p_up: float
    p_dn: float
    up_slots_first: int
    up_slots: int
    dn_slots: int
    up_bits_first: float
    up_bits: float
    dn_bits: float
    n_links: int
    t_max_slots: int
    tau_s: float

    @classmethod
    def build(cls, protocol: str, ch, *, n_mod: int, n_labels: int,
              sample_bits: int = 0, n_seed: int = 0,
              codec="identity", n_links: int | None = None) -> "LinkPlan":
        plan = round_slot_plan(protocol, ch, n_mod=n_mod,
                               n_labels=n_labels, sample_bits=sample_bits,
                               n_seed=n_seed, codec=codec)
        return cls(p_up=plan["p_up"], p_dn=plan["p_dn"],
                   up_slots_first=plan["up_slots_first"],
                   up_slots=plan["up_slots"], dn_slots=plan["dn_slots"],
                   up_bits_first=plan["up_bits_first"],
                   up_bits=plan["up_bits"], dn_bits=plan["dn_bits"],
                   n_links=ch.num_devices if n_links is None else n_links,
                   t_max_slots=ch.t_max_slots, tau_s=ch.tau_s)

    def draw(self, key, first_round: bool) -> dict:
        """One round's channel outcome: ``up_ok``/``dn_ok`` as numpy bool
        arrays, per-link slot counts and ``latency_s``."""
        out = round_trip_traced(
            key, self.p_up,
            self.up_slots_first if first_round else self.up_slots,
            self.p_dn, self.dn_slots, self.n_links, self.t_max_slots,
            self.tau_s)
        out["up_ok"] = out["up_ok"].cpu().numpy()
        out["dn_ok"] = out["dn_ok"].cpu().numpy()
        return out


def uplink_stage(spec: CodecSpec, protocol: str, dev_params, favg, key,
                 dev_gout, g_params):
    """One round's uplink payload through the codec.  ``dev_params``
    leaves, ``favg`` and ``dev_gout`` are device-stacked (D, ...).
    Returns ``(dev_params_rx, favg_rx)``, what the server decodes; the
    protocol's other half passes through.  Device d encodes with
    ``split(key, D)[d]``; the references are the receiver-tracked
    ``dev_gout`` (tables) and the round's starting global model (FL).
    ``identity`` draws nothing and returns its inputs."""
    if spec.name == "identity":
        return dev_params, favg
    if canonical_protocol(protocol) == "fl":
        leaf = next(iter(next(iter(dev_params.values())).values()))
        dkeys = rng.split(key, leaf.shape[0])
        coded = encode_params(spec, dev_params, dkeys, g_params)
        return decode_params(spec, coded, g_params), favg
    dkeys = rng.split(key, favg.shape[0])
    coded = encode_table(spec, favg, dkeys, dev_gout)
    return dev_params, decode_table(spec, coded, dev_gout)


def make_uplink_stage(codec, protocol: str):
    """:func:`uplink_stage` with the codec and the protocol closed over:
    ``stage(dev_params, favg, key, dev_gout, g_params)``."""
    spec = parse_codec(codec)

    def stage(dev_params, favg, key, dev_gout, g_params):
        return uplink_stage(spec, protocol, dev_params, favg, key,
                            dev_gout, g_params)

    return stage


def downlink_gout(dev_gout, gout, dn_ok):
    """Deliver the new G_out table to the devices whose downlink decoded;
    the rest keep their copy.  dev_gout (D, C, C), gout (C, C), dn_ok
    (D,) bool."""
    return torch.where(dn_ok[:, None, None], gout[None], dev_gout)


def downlink_params(dev_params, g_params, dn_ok):
    """Deliver the global model to the devices whose downlink decoded.
    ``dev_params`` leaves (D, ...), ``g_params`` leaves (...)."""
    def leaf(dp, gp):
        mask = dn_ok.reshape((-1,) + (1,) * (dp.dim() - 1))
        return torch.where(mask, gp[None], dp)

    return {k: {n: leaf(v[n], g_params[k][n]) for n in v}
            for k, v in dev_params.items()}
