"""Rayleigh block-fading link simulation (eq. 4).

SNR_{d,t} = P h_{d,t} r_d^-alpha / (W^y N_0),  h ~ Exp(1) IID.
A slot decodes iff SNR >= theta, delivering tau * W^y * log2(1 + theta)
bits.  Latency T^y = first slot where cumulative bits >= payload;
outage if T^y > T_max.  The draws are the reference's (see ``rng``), so
equal keys give equal masks and latencies.  The straggler stage
(``compute_mean_s > 0``) waits for the service slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import rng


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Paper Sec. IV defaults."""
    num_devices: int = 10
    num_channels: int = 2          # N_ch
    bandwidth_hz: float = 10e6     # W
    p_up_dbm: float = 23.0
    p_dn_dbm: float = 40.0
    distance_m: float = 1000.0     # r_d
    pathloss_exp: float = 4.0      # alpha
    noise_dbm_hz: float = -174.0   # N_0
    theta: float = 3.0             # target SNR (linear)
    tau_s: float = 1e-3            # slot / coherence time
    t_max_slots: int = 100
    # straggler model (disabled at the defaults; not ported yet)
    compute_mean_s: float = 0.0
    deadline_s: float = float("inf")

    def __post_init__(self):
        if self.compute_mean_s > 0.0:
            raise NotImplementedError(
                "the straggler stage (compute_mean_s > 0) is not ported "
                "yet (ROADMAP A11)")

    def link_budget(self, up: bool) -> tuple[float, float]:
        """Returns (success probability per slot, bits per good slot)."""
        w = self.bandwidth_hz * (self.num_channels / self.num_devices
                                 if up else 1.0)
        p_tx = 10 ** (((self.p_up_dbm if up else self.p_dn_dbm) - 30) / 10)
        n0 = 10 ** ((self.noise_dbm_hz - 30) / 10)
        noise = w * n0
        mean_snr = p_tx * self.distance_m ** (-self.pathloss_exp) / noise
        p_success = math.exp(-self.theta / mean_snr)  # P(h >= theta/meanSNR)
        bits = self.tau_s * w * math.log2(1.0 + self.theta)
        return p_success, bits


def slots_needed(payload_bits: float, bits_per_slot: float) -> int:
    """Host-side decode-slot requirement for one payload (>= 1)."""
    return max(1, math.ceil(payload_bits / bits_per_slot))


def link_outcomes(key, p_success: float, slots: int, n_links: int,
                  t_max_slots: int):
    """(latency_slots (n,), success (n,)): a link's latency is the first
    slot where its decoded slots reach ``slots``, t_max on outage."""
    good = rng.bernoulli(key, p_success, (n_links, t_max_slots))
    reached = torch.cumsum(good.to(torch.int32), dim=1) >= slots
    ok = reached.any(dim=1)
    first = reached.to(torch.int8).argmax(dim=1) + 1
    return torch.where(ok, first, t_max_slots), ok


def slowest_ok_slots(t, ok, t_max_slots: int) -> int:
    """Slots spent waiting on the slowest *successful* link; the full
    window only when every link outages."""
    if not bool(ok.any()):
        return t_max_slots
    return int(torch.where(ok, t, 0).max())


def round_trip_traced(key, p_up, up_slots, p_dn, dn_slots, n_links: int,
                      t_max_slots: int, tau_s: float):
    """One round's uplink (FDMA unicast) + downlink (multicast) draw.

    Latency: tau * (slowest successful T_up + slowest successful T_dn),
    rounded to float32 as the reference computes it."""
    k = rng.split(key, 2)
    t_up, ok_up = link_outcomes(k[0], p_up, up_slots, n_links, t_max_slots)
    t_dn, ok_dn = link_outcomes(k[1], p_dn, dn_slots, n_links, t_max_slots)
    slots = (slowest_ok_slots(t_up, ok_up, t_max_slots) +
             slowest_ok_slots(t_dn, ok_dn, t_max_slots))
    latency_s = torch.tensor(tau_s, dtype=torch.float32) * float(slots)
    return {"up_ok": ok_up, "dn_ok": ok_dn, "t_up": t_up, "t_dn": t_dn,
            "latency_s": float(latency_s)}
