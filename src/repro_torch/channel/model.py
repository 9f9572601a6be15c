"""Rayleigh block-fading link simulation (eq. 4).

SNR_{d,t} = P h_{d,t} r_d^-alpha / (W^y N_0),  h ~ Exp(1) IID.
A slot decodes iff SNR >= theta, delivering tau * W^y * log2(1 + theta)
bits.  Latency T^y = first slot where cumulative bits >= payload;
outage if T^y > T_max.  The straggler stage (``compute_mean_s > 0``)
draws each device's compute time ~ Exp(compute_mean_s) and drops the
devices past ``deadline_s``.  The draws are the reference's (see
``rng``), so equal keys give equal masks and latencies.  Every function
here only issues device work and returns tensors (Python constants
enter as scalars, never as host-to-device copies): the host reads them
in ``LinkPlan.collect`` (``channel/pipeline.py``).
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
    # Straggler model: per-device local compute time ~ Exp(compute_mean_s)
    # drawn each round; a device past deadline_s is dropped from the
    # aggregation set exactly like an uplink outage.  The defaults
    # disable the stage (no draw, no latency term).
    compute_mean_s: float = 0.0
    deadline_s: float = float("inf")

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


def link_outcomes(key, p_success, slots, n_links: int,
                  t_max_slots: int):
    """(latency_slots (..., n), success (..., n)): a link's latency is the
    first slot where its decoded slots reach ``slots``, t_max on outage.
    ``key`` (..., 2) may carry leading grid axes; ``p_success`` and
    ``slots`` are then numbers or tensors over them (a sweep group's
    per-point link budgets), and each point draws what a loop run with
    its key and budget draws."""
    good = rng.bernoulli(key, p_success, (n_links, t_max_slots))
    if torch.is_tensor(slots):
        slots = slots.reshape(slots.shape + (1, 1))
    reached = torch.cumsum(good.to(torch.int32), dim=-1) >= slots
    ok = reached.any(dim=-1)
    first = reached.to(torch.int8).argmax(dim=-1) + 1
    return torch.where(ok, first, t_max_slots), ok


def slowest_ok_slots(t, ok, t_max_slots: int):
    """Slots spent waiting on the slowest *successful* link; the full
    window only when every link outages.  Reduces the last (link) axis."""
    return torch.where(ok.any(dim=-1),
                       torch.where(ok, t, 0).amax(dim=-1), t_max_slots)


def compute_outcomes(key, mean_s: float, deadline_s: float, n_links: int):
    """The straggler stage's draw: (compute_s (n,) float32, finished (n,)
    bool), t ~ Exp(mean_s) and finished iff t <= deadline_s."""
    t = rng.exponential(key, (n_links,)) * mean_s
    return t, t <= deadline_s


def slowest_ok_time(t, ok, deadline_s: float):
    """Seconds spent waiting on the slowest device that *finished*; the
    full deadline only when every device straggles.  A 0-dim float32."""
    return torch.where(ok.any(), torch.where(ok, t, 0.0).max(),
                       deadline_s)


def simulate_link(key, cfg: ChannelConfig, payload_bits: float, up: bool,
                  n_links: int):
    """``n_links`` independent links of one direction for one global
    update: (latency_slots (n,), success (n,) bool), the draw of
    :func:`link_outcomes` under ``cfg``'s link budget."""
    p, bits = cfg.link_budget(up)
    return link_outcomes(key, p, slots_needed(payload_bits, bits), n_links,
                         cfg.t_max_slots)


def round_trip(key, cfg: ChannelConfig, up_bits: float, dn_bits: float):
    """One global update on the host's terms: per-device uplink (FDMA
    unicast) and downlink (multicast) outcomes under ``cfg``, and the
    round's latency as a Python float, tau * (slowest successful T_up +
    slowest successful T_dn), read back from the device.  The same
    draws as :func:`round_trip_traced` from the same key."""
    k = rng.split(key, 2)
    t_up, ok_up = simulate_link(k[0], cfg, up_bits, True, cfg.num_devices)
    t_dn, ok_dn = simulate_link(k[1], cfg, dn_bits, False, cfg.num_devices)
    latency_s = cfg.tau_s * (
        float(slowest_ok_slots(t_up, ok_up, cfg.t_max_slots)) +
        float(slowest_ok_slots(t_dn, ok_dn, cfg.t_max_slots)))
    return {"up_ok": ok_up, "dn_ok": ok_dn, "t_up": t_up, "t_dn": t_dn,
            "latency_s": latency_s}


def round_trip_traced(key, p_up, up_slots, p_dn, dn_slots, n_links: int,
                      t_max_slots: int, tau_s: float):
    """One round's uplink (FDMA unicast) + downlink (multicast) draw.

    Latency: tau * (slowest successful T_up + slowest successful T_dn),
    a float32 tensor as the reference computes it: 0-dim for one key
    (2,); (G,) for a sweep group's keys (G, 2) with (G,) tensors of
    ``p_up``, ``up_slots``, ``p_dn`` and ``dn_slots``, the reference's
    vmap of this draw over the grid."""
    k = rng.split(key, 2)
    t_up, ok_up = link_outcomes(k[..., 0, :], p_up, up_slots, n_links,
                                t_max_slots)
    t_dn, ok_dn = link_outcomes(k[..., 1, :], p_dn, dn_slots, n_links,
                                t_max_slots)
    slots = (slowest_ok_slots(t_up, ok_up, t_max_slots) +
             slowest_ok_slots(t_dn, ok_dn, t_max_slots))
    return {"up_ok": ok_up, "dn_ok": ok_dn, "t_up": t_up, "t_dn": t_dn,
            "latency_s": slots.to(torch.float32) * tau_s}
