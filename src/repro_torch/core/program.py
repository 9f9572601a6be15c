"""The round program: ``step(state, xs)`` then ``finalize()``, the one
execution face of the round loop (``FederatedTrainer.run`` and the
service, ``launch/service.py``).

* :class:`ProgramOptions` — the execution knobs: the 2-D ``(grid,
  device)`` mesh shape and the depth of the link-draw pipeline.
* :class:`LoopRoundProgram` — the host round loop.  At ``pipeline_depth
  = d`` the channel, outage and straggler draws of rounds ``p .. p + d -
  1`` are dispatched (``LinkPlan.dispatch``; on CUDA on a side stream)
  when round ``p`` starts, so a draw's device work runs beside the
  local steps queued after it (the host still issues its launches).
  This is legal because a link outcome is a
  function of ``(plan, key)`` alone and round ``q``'s key is
  ``fold_in(fold_in(run_key, q), 3)``, known from round 1.  Depth only
  changes when a draw is issued, never what it returns: every depth
  gives the same records bit for bit.

* :class:`GridRoundProgram` — the sweep engine's program
  (``sweep/engine.py``): ``step`` enqueues a group's whole schedule, one
  grid round step (``core/protocols.py`` :class:`GridRoundStep`) per
  round, without reading anything back; ``finalize`` waits once and
  returns the rounds' outputs to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import rng
from .state import RoundState


@dataclasses.dataclass(frozen=True)
class ProgramOptions:
    """Execution options of a round program.

    ``mesh_shape`` — ``(grid_shards, device_shards)`` for the sweep's 2-D
    mesh, validated as two positive ints (a budget the engine re-fits
    per group); the loop program ignores it, as the reference's does
    (the trainer's ``shard_devices`` mesh is 1-D).
    ``pipeline_depth`` — rounds of link draws in flight: 1 = dispatch
    and collect in the same round; 2 = round p+1's draw issued during
    round p."""
    mesh_shape: Optional[tuple] = None
    pipeline_depth: int = 1

    def __post_init__(self):
        if self.pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, "
                             f"got {self.pipeline_depth}")
        if self.mesh_shape is not None:
            shape = tuple(int(s) for s in self.mesh_shape)
            if len(shape) != 2 or any(s < 1 for s in shape):
                raise ValueError(f"mesh_shape must be two positive ints "
                                 f"(grid, device), got {self.mesh_shape}")
            object.__setattr__(self, "mesh_shape", shape)


class LoopRoundProgram:
    """``round_once`` behind one ``step(state, xs)`` face, with the
    dispatch window around it.

    ``xs`` holds ``dev_x``/``dev_y``/``test_x``/``test_y`` (tensors on
    the trainer's device) and optionally ``plan`` and ``log``; inputs
    that never change can be bound once with :meth:`bind`.  The window
    is keyed by round number; a held draw whose plan differs from the
    round's (a cohort-size change under churn) is dropped and the round
    draws anew.  ``dispatched``, ``collected`` and (at
    :meth:`finalize`) ``abandoned`` count the window's draws."""

    def __init__(self, trainer, options: Optional[ProgramOptions] = None):
        self.trainer = trainer
        self.options = options or ProgramOptions()
        self._bound: dict = {}
        self._pending: dict = {}   # round -> (plan, dispatch handle)
        self.dispatched = 0
        self.collected = 0

    def bind(self, **xs) -> "LoopRoundProgram":
        """Fix step inputs (``dev_x=..., test_x=...``) for every round."""
        self._bound.update(xs)
        return self

    def _round_key(self, state: RoundState, q: int):
        return rng.fold_in(rng.fold_in(state.key, q), 3)

    def _top_up(self, state: RoundState, plan) -> None:
        """Dispatch the draws of the window's rounds that have none in
        flight, and drop the handles of rounds already passed (after a
        restore)."""
        p = state.round + 1
        for q in range(p, p + self.options.pipeline_depth):
            if q not in self._pending:
                self._pending[q] = (plan, plan.dispatch(
                    self._round_key(state, q), first_round=q == 1))
                self.dispatched += 1
        for q in list(self._pending):
            if q < p:
                del self._pending[q]

    def step(self, state, xs: Optional[dict] = None):
        """One round: ``(new_state, record)`` of ``round_once``, which
        collects the round's handle where the serial path would draw."""
        xs = {**self._bound, **(xs or {})}
        state = RoundState.from_mapping(state)
        plan = xs.get("plan")
        if plan is None:
            plan = self.trainer.link_plan(
                state.g_params, n_links=self.trainer.fc.cohort_size())
        p = state.round + 1
        self._top_up(state, plan)
        held_plan, handle = self._pending.pop(p)
        if held_plan is not plan and held_plan != plan:
            handle = None          # plan changed since dispatch: re-draw
        if handle is not None:
            self.collected += 1
        return self.trainer.round_once(
            state, xs["dev_x"], xs["dev_y"], xs["test_x"], xs["test_y"],
            plan=plan, log=xs.get("log"), _pending_link=handle)

    def finalize(self) -> dict:
        """Drop the draws still in flight and report the window's
        stats."""
        stats = {"dispatched": self.dispatched,
                 "collected": self.collected,
                 "abandoned": len(self._pending),
                 "pipeline_depth": self.options.pipeline_depth}
        self._pending.clear()
        return stats


class GridRoundProgram:
    """A sweep group's rounds behind the same face.  ``step(state, xs)``
    runs ``step_fn`` once per round dict of ``xs`` (the engine's
    precomputed per-round inputs), each round issuing its device work
    after the last, and keeps the rounds' outputs as (R, G) tensors on
    the device: nothing is read to the host, so the whole schedule is
    queued without a wait.  ``finalize`` waits for the device once and
    returns ``(state, outputs)`` with the outputs as numpy arrays.  The
    link draws are part of each round's queued work, so
    ``pipeline_depth`` does not apply; the mesh option does, in the
    engine, which lays the group's points along the "grid" axis of
    ``launch.mesh.make_grid_mesh``'s 2-D mesh."""

    def __init__(self, step_fn: Callable, state0,
                 options: Optional[ProgramOptions] = None):
        self.options = options or ProgramOptions()
        self._step_fn = step_fn
        self.state = RoundState.from_mapping(state0)
        self._out: dict = {}

    def step(self, state, xs):
        """Queue every round of ``xs`` from ``state``; returns the final
        state and the stacked outputs, both still on the device."""
        state = RoundState.from_mapping(state)
        outs = []
        for x in xs:
            state, out = self._step_fn(state, x)
            outs.append(out)
        self.state = state
        self._out = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return state, self._out

    def finalize(self):
        """Wait for the queued rounds; ``(state, {name: (R, G) array})``."""
        leaf = self.state.converged_round
        if leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
        return self.state, {k: v.cpu().numpy() for k, v in self._out.items()}
