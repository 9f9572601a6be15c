"""One training step replayed from a CUDA graph.

A local SGD step (``core/protocols.py``) or an eq. (5) step
(``core/conversion.py``) issues a few dozen small kernels.  Issued from
Python each costs more host time than the device needs to run it, so a
round issued step by step is bound by the host.  :class:`StepGraph`
captures the step once with ``torch.cuda.graph`` and replays it: one
host call per replay.

The step is a function of no arguments that works in place on static
buffers, which keep their addresses from call to call.  Its step index
is a device counter that the step reads (``idx.index_select(.., k)``)
and increments (``k.add_(1)``), so the replays walk the steps without
the host.  On the CPU the same function runs eagerly, so the CPU tests
exercise the code that the card captures.  :class:`CapturedSteps` keeps
the static buffers of a training step (its parameters' leaves, its
inputs and its outputs) and their graph, one per input layout.

On CUDA there is no fallback: if the capture fails, :meth:`StepGraph.run`
raises and the steps asked for do not run eagerly.
"""
from __future__ import annotations

import time

import torch

from ..kernels import runtime


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


class StepGraph:
    """Runs ``step`` a given number of times per :meth:`run`; ``counter``
    is the step's index, a one-element int64 tensor on the step's device
    that the step reads and increments, set to 0 before the first step
    of each run.

    On CUDA the first :meth:`run` runs its first ``warmup`` steps (at
    most the run's) eagerly on a side stream, which loads the kernel
    libraries and their modules, creates the cuDNN handles and fills the
    allocator's pool, then captures one step and replays it for the rest;
    later runs are replays only.

    Launch counts (``kernels.runtime``) count the launches that ran: a
    kernel launched while the graph is captured is recorded, not run, so
    the capture's launches are taken back out, and each replay adds
    them.  ``warm_steps`` and ``warmed`` hold the warm-up's steps and
    launches, ``captured`` the launches in one replay, ``replays`` the
    replays so far, and ``warmup_s`` and ``capture_s`` the host seconds
    that the warm-up and the capture took.
    """

    def __init__(self, step, counter, warmup: int = 3):
        self.step = step
        self.counter = counter
        self.device = counter.device
        self.warmup = warmup
        self.graph = None
        self.warm_steps = 0
        self.warmed: dict = {}
        self.captured: dict = {}
        self.replays = 0
        self.warmup_s = self.capture_s = 0.0

    def run(self, load, n: int) -> None:
        """``load()`` puts this call's inputs into the static buffers;
        then ``n`` steps run."""
        load()
        self.counter.zero_()
        if self.device.type != "cuda":
            for _ in range(n):
                self.step()
            return
        done = 0 if self.graph is not None else self._capture(
            min(self.warmup, n))
        for _ in range(n - done):
            self.graph.replay()
            runtime.add_launches(self.captured)
            self.replays += 1

    def _capture(self, warmup: int) -> int:
        """Runs ``warmup`` steps on a side stream, captures one; returns
        the steps run."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        before = runtime.launch_counts()
        with torch.cuda.stream(side):
            for _ in range(warmup):
                self.step()
        current.wait_stream(side)
        warm = runtime.launch_counts()
        self.warm_steps, self.warmed = warmup, _delta(before, warm)
        torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self.step()
        except RuntimeError as e:
            raise RuntimeError(
                "capturing the step in a CUDA graph failed (a host sync "
                "such as .item() inside the step?); the step does not run "
                "eagerly on the GPU") from e
        finally:
            self.captured = _delta(warm, runtime.launch_counts())
            # recorded, not run: each replay counts them
            runtime.add_launches(self.captured, times=-1)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        return warmup


def leaves_of(tree) -> list:
    return [t for v in tree.values() for t in v.values()]


def unflatten(like, leaves):
    it = iter(leaves)
    return {k: {n: next(it) for n in v} for k, v in like.items()}


class StepBuffers:
    """The static buffers of one training step: ``leaves`` (the
    parameters' leaves, requiring grad), ``params`` (the same leaves in
    the parameters' tree), ``inputs`` and ``outputs`` (float32, zeroed at
    each load) by name, and ``k``, the step index."""

    def __init__(self, params, inputs: dict, outputs: dict):
        dev = next(iter(inputs.values())).device
        self.leaves = [torch.empty_like(t).requires_grad_(True)
                       for t in leaves_of(params)]
        self.params = unflatten(params, self.leaves)
        self.inputs = {n: torch.empty_like(t) for n, t in inputs.items()}
        self.outputs = {n: torch.zeros(s, device=dev)
                        for n, s in outputs.items()}
        self.k = torch.zeros(1, dtype=torch.int64, device=dev)

    def load(self, params, inputs: dict) -> None:
        with torch.no_grad():
            for dst, src in zip(self.leaves, leaves_of(params)):
                dst.copy_(src)
            for n, t in inputs.items():
                self.inputs[n].copy_(t)
            for t in self.outputs.values():
                t.zero_()


class CapturedSteps:
    """``n`` steps of a training step over static buffers, with their
    :class:`StepGraph`, one per input layout, built at first use and
    kept.  At each call the parameters and inputs are copied in and the
    outputs zeroed; the trained parameters and the outputs are copied
    out, so what a call returns never aliases a buffer that the next
    call overwrites."""

    def __init__(self):
        self._built = {}

    @property
    def graphs(self):
        return [g for _, g in self._built.values()]

    @property
    def buffers(self):
        return [b for b, _ in self._built.values()]

    def __call__(self, make_step, params, inputs: dict, outputs: dict,
                 n: int):
        """``make_step(buf)`` returns the step on the :class:`StepBuffers`
        ``buf`` (called when the layout is first seen); ``outputs`` maps
        names to shapes.  Returns (trained params, outputs)."""
        layout = (tuple((k, m, tuple(t.shape)) for k, v in
                             params.items() for m, t in v.items()),
                  tuple((name, t.device, t.dtype, tuple(t.shape))
                        for name, t in inputs.items()))
        if layout not in self._built:
            buf = StepBuffers(params, inputs, outputs)
            self._built[layout] = buf, StepGraph(make_step(buf), buf.k)
        buf, graph = self._built[layout]
        graph.run(lambda: buf.load(params, inputs), n)
        return (unflatten(params, [t.detach().clone() for t in buf.leaves]),
                {name: t.clone() for name, t in buf.outputs.items()})
