"""CUDA graphs of the engines' served steps: the port's twin of the JAX
engines' ``jax.jit``.

A :class:`StepGraphs` holds one engine's captured steps, keyed by what
changes the launches (the vision bucket, the token engine's draw branch),
in one memory pool.  A step is captured at its first use: warmed up on a
side stream (which also builds the kernels it launches; one such stream
per device, shared by every engine), captured once, then replayed by
that call and every later one.  Every graph output is
read before the next replay, so graphs that share the pool never hold
live data across one another's replays.

The kernel wrappers count launches on the host, and a replay runs no
host code.  So the counters are read around the capture pass, put back
where they stood before the warm-up, and every replay adds the capture
pass's counts: after a graph-served run ``kernels.counts()`` reads what
the eager run leaves, launch for launch.

Graphs run only on CUDA (:func:`for_device`) and never inside
``ops.reference_path()`` (:func:`in_use`): a step there runs eagerly, so
a graph captured on the kernel path never stands in for the plain
versions.  A capture that fails raises; nothing falls back to the eager
step.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Optional, Sequence

import torch

from .. import kernels
from ..kernels import ops

WARMUP = 3  # eager calls on a side stream before a capture
_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}  # device -> warm-up stream


def for_device(device: torch.device, graphs: bool) -> Optional["StepGraphs"]:
    """An engine's graphs: a :class:`StepGraphs` when ``graphs`` is set and
    the engine runs on CUDA, else None (eager: there is no CUDA graph to
    capture on the CPU, as JAX's jit compiles no TPU program there)."""
    return StepGraphs() if graphs and device.type == "cuda" else None


def in_use(step_graphs: Optional["StepGraphs"]) -> bool:
    """Whether this step replays a graph: graphs exist and the caller is
    not inside ``ops.reference_path()``."""
    return step_graphs is not None and not ops._REFERENCE.get()


def _plus(a: dict, b: dict, sign: int = 1) -> dict:
    return {k: {f: a[k][f] + sign * b[k][f] for f in a[k]} for k in a}


def _side_stream() -> torch.cuda.Stream:
    """The current device's one warm-up stream.  torch keeps a cuBLAS
    workspace for every (handle, stream) pair that has run a matmul, for
    the life of the process, so a fresh side stream per capture grew
    allocated memory with every engine built -- with every supervisor
    restart (by 32 MiB a build on an NVIDIA H100 80GB HBM3 at 700 W)."""
    dev = torch.cuda.current_device()
    side = _SIDE_STREAMS.get(dev)
    if side is None:
        side = _SIDE_STREAMS[dev] = torch.cuda.Stream()
    return side


def _warm_up(fn: Callable) -> None:
    side = _side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)


def _record(fn: Callable, pool, generators: Sequence[torch.Generator]):
    """(graph, fn's output): one call of ``fn`` captured; draws from
    ``generators`` replay as the eager calls would take them."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return graph, out


class StepGraph:
    """One captured step: ``replay()`` runs it and counts its launches."""

    def __init__(self, graph, out, delta: dict):
        self.graph = graph
        self.out = out      # static: overwritten by the next replay
        self.delta = delta  # kernels.counts() of the capture pass

    def replay(self):
        self.graph.replay()
        kernels.set_counts(_plus(kernels.counts(), self.delta))
        return self.out


class StepGraphs:
    """One engine's captured steps by key, sharing one memory pool."""

    def __init__(self):
        self._graphs: Dict[Hashable, StepGraph] = {}
        self._pool = None
        self.capture_s = 0.0  # host seconds spent warming up and capturing

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key: Hashable, fn: Callable,
            state: Sequence[torch.Tensor] = (),
            generators: Sequence[torch.Generator] = ()):
        """Replay ``key``'s graph and return its output, capturing ``fn``
        first if ``key`` has none.  ``state``: tensors ``fn`` writes in
        place; they and the ``generators`` are put back after the warm-up,
        so only the replay changes them."""
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(fn, state, generators)
        return g.replay()

    def _capture(self, fn, state, generators) -> StepGraph:
        t0 = time.perf_counter()
        before = kernels.counts()
        try:
            saved = [t.clone() for t in state]
            rng = [g.get_state() for g in generators]
            _warm_up(fn)
            for t, s in zip(state, saved):
                t.copy_(s)
            for g, s in zip(generators, rng):
                g.set_state(s)
            del saved
            mid = kernels.counts()
            graph, out = _record(fn, self._pool, generators)
            delta = _plus(kernels.counts(), mid, -1)
        finally:
            kernels.set_counts(before)
        self._pool = graph.pool()
        self.capture_s += time.perf_counter() - t0
        return StepGraph(graph, out, delta)
