"""Result frames of a sweep: the (G, R) per-round histories of every
grid point and the wall time of the run that produced them (the
reference's ``SweepResult``).

``history(g)`` rebuilds the per-point dict of ``FederatedTrainer.run``
(the equivalence tests compare them field by field); ``frames()``
flattens the grid into JSON-ready rows.  Channel latency is simulated
per round and point, but compute time exists only for the sweep as a
whole, so ``cum_time_s`` spreads the sweep's wall time evenly over the
points and rounds.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SweepResult:
    grid: object                 # sweep.axes.SweepGrid
    acc: np.ndarray              # (G, R)
    loss: np.ndarray             # (G, R)
    latency_s: np.ndarray        # (G, R)
    up_ok: np.ndarray            # (G, R) int
    converged: np.ndarray        # (G,) int32, 0 = never
    wall_s: float
    # per-point link accounting (codec-aware; None on results built by
    # older callers): uplink payload bits first/steady rounds, and the
    # cumulative DP epsilon after R rounds (NaN at non-DP points)
    up_bits_first: np.ndarray | None = None   # (G,)
    up_bits: np.ndarray | None = None         # (G,)
    dp_epsilon: np.ndarray | None = None      # (G,)
    # participation-aware DP: worst per-device epsilon (composed over
    # the rounds each device actually joined — equals dp_epsilon at
    # sample_ratio=1) and the full per-point accountant ledgers
    dp_epsilon_device: np.ndarray | None = None   # (G,)
    dp: tuple | None = None                       # (G,) ledger dict|None

    @property
    def rounds(self) -> int:
        return self.acc.shape[1]

    def cum_time_s(self, g: int) -> list[float]:
        """Cumulative latency + amortized compute for point ``g``."""
        per_round_compute = self.wall_s / (self.grid.size * self.rounds)
        lat = np.cumsum(self.latency_s[g])
        return list(lat + per_round_compute * np.arange(1, self.rounds + 1))

    def history(self, g: int) -> dict:
        """Per-point history in ``FederatedTrainer.run``'s shape (minus
        the host-only seeds/compute_s fields)."""
        h = {
            "acc": [float(a) for a in self.acc[g]],
            "loss": [float(l) for l in self.loss[g]],
            "round_latency_s": [float(t) for t in self.latency_s[g]],
            "uplink_ok": [int(u) for u in self.up_ok[g]],
            "cum_time_s": self.cum_time_s(g),
            "converged_round": (int(self.converged[g])
                                if self.converged[g] else None),
            "final_acc": float(self.acc[g, -1]),
            "protocol": self.grid.points[g][0].protocol,
            "model": self.grid.points[g][0].model_key(),
            "task": self.grid.points[g][0].task,
        }
        if self.dp is not None and self.dp[g] is not None:
            h["dp"] = self.dp[g]  # the loop path's history["dp"] ledger
        return h

    def uplink_bits_total(self, g: int) -> float | None:
        """Per-device uplink bits over the whole run: one first round +
        (R - 1) steady-state rounds of point ``g``."""
        if self.up_bits is None:
            return None
        return float(self.up_bits_first[g] +
                     (self.rounds - 1) * self.up_bits[g])

    def frames(self) -> list[dict]:
        """One JSON-ready row per grid point: axis values + summary."""
        rows = []
        for g, label in enumerate(self.grid.labels()):
            h = self.history(g)
            row = {
                "point": self.grid.point_name(g, label),
                **label,
                "final_acc": h["final_acc"],
                "cum_time_s": h["cum_time_s"][-1],
                "round1_latency_s": h["round_latency_s"][0],
                "converged_round": h["converged_round"],
                "acc": h["acc"],
            }
            if self.up_bits is not None:
                row["uplink_bits"] = float(self.up_bits[g])
                row["uplink_bits_total"] = self.uplink_bits_total(g)
                eps = float(self.dp_epsilon[g])
                # NaN -> None: non-DP points have no finite epsilon, and
                # the result payload stays strict-JSON serializable
                row["dp_epsilon"] = None if np.isnan(eps) else eps
                if self.dp_epsilon_device is not None:
                    dev = float(self.dp_epsilon_device[g])
                    row["dp_epsilon_device_max"] = (None if np.isnan(dev)
                                                    else dev)
            rows.append(row)
        return rows

    def to_payload(self) -> dict:
        """Whole-sweep JSON payload (grid axes + per-point frames).
        ``protocols`` lists the distinct protocols of the grid (one entry
        for classic homogeneous grids); ``protocol`` keeps the first
        point's protocol for backward compatibility."""
        protos = []
        for fc, _ in self.grid.points:
            if fc.protocol not in protos:
                protos.append(fc.protocol)
        return {
            "protocol": protos[0],
            "protocols": protos,
            "axes": {n: list(v) for n, v in self.grid.axes},
            "grid_shape": list(self.grid.shape),
            "wall_s": round(self.wall_s, 4),
            "points": self.frames(),
        }
