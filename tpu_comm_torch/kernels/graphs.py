"""CUDA graphs of the port's dispatches, with launch counts that read what
the card ran.

JAX compiles a loop of steps into one program and dispatches it once
(``lax.fori_loop`` in a ``jit``); the port's counterpart on the card is
a ``torch.cuda.CUDAGraph`` of the loop, captured once and replayed a
dispatch, so the host's launches and P2P calls (the larger part of an
eager mesh step) are paid once at capture.

:class:`Graph` wraps a function ``fn()`` that reads and writes only
tensors that outlive it (its static buffers). The first call runs ``fn``
eagerly on a side stream: that is the warm-up capture needs (NCCL
creates its communicator and channels at the first transfer, the
kernels' libraries load), and its result is the first call's. The card
is then synchronised and ``fn`` captured; capture records and runs
nothing, so every later call is a replay. A capture that fails raises:
there is no eager fallback.

Launch counts: a wrapper counts its kernel once while it is captured,
though nothing ran. The capture's counts are taken back and kept in
``captured`` (wrapper -> launches a replay makes), and every replay adds
them, so the counters read what the card ran.
"""

from __future__ import annotations

import os
import re
import tempfile
from pathlib import Path

import torch

from tpu_comm_torch.kernels import launch_wrappers

#: the most trips (steps; ``multi`` passes, deep-halo windows) one graph
#: of a mesh run holds. Capture costs what the eager trips cost once
#: (the host's launches, up to ~4 ms a step on the card), and a graph
#: holds every launch and P2P call of its trips as a node (the periodic
#: 3D block step makes ~50 device ops a step: ~3200 nodes at 64). At
#: 64, a slope's loops of 20 and 60 steps, the card check's length, are
#: one graph each; longer loops replay a divisor (300 steps: 5 x 60).
GRAPH_MAX_TRIPS = 64


def graph_chunk(trips: int, cap: int = GRAPH_MAX_TRIPS) -> int:
    """The trips one graph of a ``trips``-trip run holds: ``trips`` itself
    up to ``cap``, beyond it the largest divisor of ``trips`` not above
    ``cap``; the run replays it ``trips / chunk`` times."""
    if trips < 1 or cap < 1:
        raise ValueError(f"need trips >= 1 and cap >= 1, got {trips}, {cap}")
    if trips <= cap:
        return trips
    return next(d for d in range(cap, 0, -1) if trips % d == 0)


def capture(fn, debug: bool = False) -> tuple[torch.cuda.CUDAGraph, dict]:
    """``fn()`` captured in a new graph; returns ``(graph, captured)``,
    ``captured`` the launches a replay makes, each taken back from its
    wrapper's count. ``debug`` keeps the graph's template beside its
    instance, so its nodes can be read (:func:`kernel_nodes`)."""
    wrappers = launch_wrappers()
    before = [w.launches for w in wrappers]
    graph = (torch.cuda.CUDAGraph(keep_graph=True) if debug
             else torch.cuda.CUDAGraph())
    with torch.cuda.graph(graph):
        fn()
    if debug:
        graph.instantiate()
    captured = {}
    for w, b in zip(wrappers, before):
        if w.launches != b:
            captured[w] = w.launches - b
            w.launches = b
    return graph, captured


#: a node statement of ``cuGraphDebugDotPrint``'s DOT output
_DOT_NODE = re.compile(r'^\s*"graph_\d+_node_\d+"\s*\[', re.MULTILINE)
#: ``CU_GRAPH_DEBUG_DOT_FLAGS_VERBOSE``: every node's every field
_DOT_VERBOSE = 1


def count_kernel_nodes(dot: str, prefix: str) -> int:
    """The nodes of a graph's DOT dump whose kernel's name starts with
    ``prefix``, demangled or mangled (``_Z<len>name``); edges are no
    node."""
    starts = [m.start() for m in _DOT_NODE.finditer(dot)]
    if not starts:
        raise RuntimeError("the graph's DOT dump holds no node")
    name = re.compile(r"(?:(?<!\w)|_Z\d+)" + re.escape(prefix))
    return sum(1 for a, b in zip(starts, starts[1:] + [len(dot)])
               if name.search(dot, a, b))


def kernel_nodes(graph: torch.cuda.CUDAGraph, prefix: str) -> int:
    """The kernel nodes of a graph captured with ``debug`` whose kernel's
    name starts with ``prefix``, read from the graph itself (the CUDA
    driver's DOT dump of its template), not from a trace of a replay."""
    import ctypes

    driver = ctypes.CDLL("libcuda.so.1")
    fd, path = tempfile.mkstemp(suffix=".dot")
    os.close(fd)
    try:
        rc = driver.cuGraphDebugDotPrint(
            ctypes.c_void_p(int(graph.raw_cuda_graph())),
            path.encode(), ctypes.c_uint(_DOT_VERBOSE))
        if rc != 0:
            raise RuntimeError(f"cuGraphDebugDotPrint returned {rc}")
        return count_kernel_nodes(Path(path).read_text(), prefix)
    finally:
        os.unlink(path)


class Graph:
    """``fn`` run eagerly once, then captured and replayed a
    ``dispatch()``. ``debug`` keeps the captured graph's template, whose
    nodes :func:`kernel_nodes` reads."""

    def __init__(self, fn, debug: bool = False):
        self.fn = fn
        self.debug = debug
        self.graph = None
        self.captured: dict = {}
        self.replays = 0

    def dispatch(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            for wrapper, n in self.captured.items():
                wrapper.launches += n
            self.replays += 1
            return
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.fn()
        current.wait_stream(side)
        torch.cuda.synchronize()
        self.graph, self.captured = capture(self.fn, self.debug)

    def release(self) -> None:
        """Free the graph. A graph holds the communicator it captured, so
        a caller releases it before the process group is destroyed (a
        group torn down under a live graph has hung at exit)."""
        if self.graph is not None:
            torch.cuda.synchronize()
            self.graph.reset()
            self.graph = None


class GraphLoop:
    """``k`` chained calls ``x = body(x)`` from ``x0`` (``x0`` only read),
    as a bench's timed loop runs them: JAX's ``fori_loop``, one dispatch.
    On the card each call of :meth:`run` replays a :class:`Graph` of
    :func:`graph_chunk` calls ``k / chunk`` times over one static buffer,
    seeded from ``x0`` (a fixed cost, which a slope cancels); the graphs
    are captured at first use, one a chunk length, and kept until
    :meth:`release`. On the CPU the calls run eagerly. Returns the last
    call's result (on the card the static buffer: read it before the next
    run)."""

    def __init__(self, body, x0: torch.Tensor):
        self.body, self.x0 = body, x0
        self.graphs: dict[int, Graph] = {}
        self.buf = None

    @property
    def dispatch(self) -> str:
        """How :meth:`run` dispatches: ``graph`` or ``eager``."""
        return "graph" if self.x0.device.type == "cuda" else "eager"

    def run(self, k: int) -> torch.Tensor:
        if self.dispatch == "eager":
            x = self.x0
            for _ in range(k):
                x = self.body(x)
            return x
        chunk = graph_chunk(k)
        if self.buf is None:
            self.buf = torch.empty_like(self.x0)
        if chunk not in self.graphs:
            def chain(chunk=chunk):
                x = self.buf
                for _ in range(chunk):
                    x = self.body(x)
                self.buf.copy_(x)
            self.graphs[chunk] = Graph(chain)
        self.buf.copy_(self.x0)
        for _ in range(k // chunk):
            self.graphs[chunk].dispatch()
        return self.buf

    def release(self) -> None:
        """Free the graphs (before the process group, as
        :meth:`Graph.release` says) and the buffer."""
        for g in self.graphs.values():
            g.release()
        self.graphs.clear()
        self.buf = None
