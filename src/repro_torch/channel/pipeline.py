"""The link pipeline: every device<->server transfer as one seam,
``encode -> channel -> decode``.

* :func:`uplink_stage` / :func:`make_uplink_stage` — the uplink codec
  stage (``channel/payload.py``): what the server decodes of each
  device's payload; :func:`grid_uplink_stage` the same for a sweep
  group's stacked points, each with its own codec parameters;
* :data:`channel_stage`, ``round_trip_traced`` of ``channel/model.py``
  (the channel draw itself, batched over a sweep group's points: (G, 2)
  keys and (G,) link budgets), passed on here: code outside the channel
  package reaches the channel model only through this module;
* :class:`LinkPlan` — the host-side link plan (per-slot success
  probabilities and decode-slot counts) and its per-round draw, split
  into :meth:`LinkPlan.dispatch` (device work only, no host copy or
  sync; on CUDA on the device's side stream) and :meth:`LinkPlan.collect`
  (every host read);
* :func:`downlink_gout` / :func:`downlink_params` — the downlink
  broadcast, gated per device by ``dn_ok``.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import rng
from ..registry import canonical_protocol
from .model import compute_outcomes, round_trip_traced, slowest_ok_time
from .payload import (CodecSpec, decode_params, decode_table, encode_params,
                      encode_table, parse_codec, round_slot_plan)


#: the channel draw itself, under the name the protocol layer calls it
channel_stage = round_trip_traced

_SIDE_STREAMS: dict = {}   # device -> the stream the draws run on


def _side_stream(device) -> torch.cuda.Stream:
    """The one side stream of ``device`` that every dispatched draw runs
    on, in issue order."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


@dataclasses.dataclass(frozen=True)
class LinkPlan:
    """Host-side link plan of one (protocol, codec, channel) point.
    ``n_links`` is the cohort on air this round; the FDMA bandwidth split
    stays at ``ChannelConfig.num_devices``.  ``compute_mean_s`` and
    ``deadline_s`` are the straggler stage's (off at the defaults)."""
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
    compute_mean_s: float = 0.0
    deadline_s: float = float("inf")

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
                   t_max_slots=ch.t_max_slots, tau_s=ch.tau_s,
                   compute_mean_s=ch.compute_mean_s,
                   deadline_s=ch.deadline_s)

    def _stages(self, key, first_round: bool) -> dict:
        out = round_trip_traced(
            key, self.p_up,
            self.up_slots_first if first_round else self.up_slots,
            self.p_dn, self.dn_slots, self.n_links, self.t_max_slots,
            self.tau_s)
        pending = {"out": out, "comp": None}
        if self.compute_mean_s > 0.0:
            # its own fold of the key: the channel stream is unchanged
            t, ok = compute_outcomes(rng.fold_in(key, 7),
                                     self.compute_mean_s, self.deadline_s,
                                     self.n_links)
            pending["comp"] = (t, ok, slowest_ok_time(t, ok,
                                                      self.deadline_s))
        return pending

    def dispatch(self, key, first_round: bool) -> dict:
        """Issue one round's channel (+ straggler) draw without reading
        anything back; :meth:`collect` reads it.  A link outcome is a
        function of ``(plan, key)`` alone, so a round's draw may be
        issued while earlier rounds train.

        On CUDA the draw runs on the device's side stream, after the work
        already queued on the current stream (which made ``key``), and
        the handle holds an event recorded behind it.  Nothing here copies
        from the host or waits for the card: the host's cost is issuing
        the draw's launches (about a thousand elementwise threefry
        operations), and like any launch it blocks only when the launch
        queue is full.  ``key`` is marked as used
        by the side stream, so the allocator keeps its memory until the
        draw has read it even if the handle is dropped.  On the CPU the
        draw runs at once."""
        if key.device.type != "cuda":
            return self._stages(key, first_round)
        side = _side_stream(key.device)
        side.wait_stream(torch.cuda.current_stream(key.device))
        key.record_stream(side)
        with torch.cuda.stream(side):
            pending = self._stages(key, first_round)
            pending["event"] = torch.cuda.Event()
            pending["event"].record(side)
        return pending

    def collect(self, pending: dict) -> dict:
        """Wait for a :meth:`dispatch` handle and assemble the round's
        link outcome: ``up_ok``/``dn_ok`` as numpy bool arrays, per-link
        slot counts and ``latency_s`` as a float.  With the straggler
        stage, late devices are AND-masked out of ``up_ok`` (``comp_ok``,
        ``t_comp_s``, ``n_straggle``), and the latency grows by the
        slowest finishing device's compute time.

        On CUDA the current stream waits for the side stream's event, and
        the tensors that leave here are marked as used by the current
        stream, so the allocator cannot hand their memory to the side
        stream's next draw early."""
        out = pending["out"]
        event = pending.get("event")
        if event is not None:
            stream = torch.cuda.current_stream(out["t_up"].device)
            stream.wait_event(event)
            out["t_up"].record_stream(stream)
            out["t_dn"].record_stream(stream)
            event.synchronize()
        up_ok = out["up_ok"].cpu().numpy()
        latency_s = float(out["latency_s"])
        result = {"up_ok": up_ok, "dn_ok": out["dn_ok"].cpu().numpy(),
                  "t_up": out["t_up"], "t_dn": out["t_dn"]}
        if pending["comp"] is not None:
            t_comp, comp_ok, slowest = pending["comp"]
            comp_ok = comp_ok.cpu().numpy()
            result["up_ok"] = up_ok & comp_ok
            result["comp_ok"] = comp_ok
            result["t_comp_s"] = t_comp.cpu().numpy()
            result["n_straggle"] = int((~comp_ok).sum())
            latency_s += float(slowest)
        result["latency_s"] = latency_s
        return result

    def draw(self, key, first_round: bool) -> dict:
        """One round's channel outcome: :meth:`collect` of
        :meth:`dispatch`, the serial schedule the overlapped one must
        equal bit for bit."""
        return self.collect(self.dispatch(key, first_round))


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
    dkeys = rng.split(key, _n_rows(dev_params, favg))
    return _code(spec, protocol, dev_params, favg, dkeys, dev_gout,
                 g_params)


def grid_uplink_stage(spec: CodecSpec, protocol: str, dev_params, favg,
                      key, dev_gout, g_params, rows):
    """:func:`uplink_stage` for a sweep group of G points of n devices,
    stacked: ``dev_params`` leaves, ``favg`` and ``dev_gout`` (G n, ...)
    with point g's device d at row ``g n + d``, ``key`` (G, 2) one a
    point, ``g_params`` leaves (G, ...), and ``rows`` the per-row
    numeric parameters (``channel/payload.py``).  Device d of point g
    encodes with ``split(key[g], n)[d]``, as its loop run does."""
    if spec.name == "identity":
        return dev_params, favg
    G = key.shape[0]
    n = _n_rows(dev_params, favg) // G
    dkeys = rng.split(key, n).reshape(G * n, 2)
    ref = None
    if canonical_protocol(protocol) == "fl":   # each device's reference
        ref = {k: {m: t[:, None].expand((G, n) + tuple(t.shape[1:]))
                   .reshape((G * n,) + tuple(t.shape[1:]))
                   for m, t in v.items()} for k, v in g_params.items()}
    return _code(spec, protocol, dev_params, favg, dkeys, dev_gout, ref,
                 rows)


def _n_rows(dev_params, favg) -> int:
    """Device rows of a payload (FL rounds may carry no table)."""
    if favg is not None:
        return favg.shape[0]
    return next(iter(next(iter(dev_params.values())).values())).shape[0]


def _code(spec, protocol, dev_params, favg, dkeys, dev_gout, g_params,
          rows=None):
    if canonical_protocol(protocol) == "fl":
        coded = encode_params(spec, dev_params, dkeys, g_params, rows)
        return decode_params(spec, coded, g_params), favg
    coded = encode_table(spec, favg, dkeys, dev_gout, rows)
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
    the rest keep their copy.  dev_gout (..., D, C, C), gout (..., C, C),
    dn_ok (..., D) bool: a loop round's (D, ...) or a sweep group's
    (G, D, ...)."""
    return torch.where(dn_ok[..., None, None], gout.unsqueeze(-3),
                       dev_gout)


def downlink_params(dev_params, g_params, dn_ok):
    """Deliver the global model to the devices whose downlink decoded.
    ``dev_params`` leaves (..., D, *p), ``g_params`` leaves (..., *p),
    ``dn_ok`` (..., D): a loop round's or a sweep group's."""
    nb = dn_ok.dim()

    def leaf(dp, gp):
        mask = dn_ok.reshape(dn_ok.shape + (1,) * (dp.dim() - nb))
        return torch.where(mask, gp.unsqueeze(nb - 1), dp)

    return {k: {n: leaf(v[n], g_params[k][n]) for n in v}
            for k, v in dev_params.items()}
