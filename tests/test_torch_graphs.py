"""A card mesh run as CUDA-graph replays (``kernels/graphs.py``,
``kernels/distributed.py`` ``run_distributed`` and
``run_distributed_to_convergence``), the parts that run on the CPU:

- the chunk planner: the trips one graph holds, a pure function;
- the launch counts through a capture and its replays, with the CUDA
  graph API replaced by stand-ins that run nothing at replay (the counts
  are the runner's bookkeeping, not the card's);
- the runners' cache: chains over one pair of buffers, and a run without
  a cache captures only what it replays;
- the NCCL nodes of a captured graph, read from its DOT dump;
- the rows: how a mesh row ran (``dispatch``, ``graph_steps``);
- a bench's timed loop (``GraphLoop``): eager on the CPU, on the card a
  graph a chunk length, kept across runs.

Graph against eager on the card, bitwise, is in ``test_torch_cuda.py``
and ``chip_smoke.py``; the CPU path is held against JAX, with a cache
it leaves empty, in ``test_torch_dist.py``.
"""

import contextlib

import pytest
import torch

from tpu_comm_torch.bench import stencil as pstencil
from tpu_comm_torch.comm import launch
from tpu_comm_torch.domain import Decomposition
from tpu_comm_torch.kernels import distributed as pdist
from tpu_comm_torch.kernels import graphs as pgraphs
from tpu_comm_torch.topo import make_cart_mesh


@pytest.mark.parametrize("trips,cap,want", [
    (1, 64, 1), (20, 64, 20), (64, 64, 64), (60, 64, 60), (65, 64, 13),
    (128, 64, 64), (300, 64, 60), (97, 64, 1), (192, 64, 64),
    (2 * 97, 64, 2), (7, 3, 1), (12, 5, 4), (1, 1, 1), (10, 1, 1),
])
def test_graph_chunk_plans_the_trips_a_graph_holds(trips, cap, want):
    chunk = pgraphs.graph_chunk(trips, cap)
    assert chunk == want
    assert trips % chunk == 0 and chunk <= cap
    # the largest such divisor
    assert not any(trips % d == 0 for d in range(chunk + 1, cap + 1))


def test_graph_chunk_defaults_to_the_cap():
    assert pgraphs.graph_chunk(60) == 60
    assert pgraphs.graph_chunk(pgraphs.GRAPH_MAX_TRIPS + 1) < (
        pgraphs.GRAPH_MAX_TRIPS)


@pytest.mark.parametrize("trips,cap", [(0, 64), (-1, 64), (5, 0)])
def test_graph_chunk_refuses_no_trips(trips, cap):
    with pytest.raises(ValueError, match="need trips >= 1"):
        pgraphs.graph_chunk(trips, cap)


# ------------------------------------------------------ launch counts

class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    """A capture that records nothing and a replay that runs nothing."""

    def replay(self):
        pass

    def reset(self):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """The CUDA stream and graph API of ``kernels/graphs.py`` replaced by
    stand-ins; one counting wrapper as the port's only one."""
    def kernel():
        kernel.launches += 1

    kernel.launches = 0
    monkeypatch.setattr(pgraphs, "launch_wrappers", lambda: [kernel])
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())
    return kernel


@pytest.mark.parametrize("trips,dispatches", [(1, 1), (3, 1), (4, 5),
                                              (20, 3)])
def test_counts_read_what_the_replays_ran(fake_cuda, trips, dispatches):
    """The first dispatch runs the chain (its launches count) and
    captures it (those are taken back); each replay adds the capture's.
    So the count is the eager chain's, dispatch by dispatch."""
    kernel = fake_cuda

    def step(src, out):
        kernel()
        return torch.add(src, 1, out=out)

    chain = pdist.GraphChain(step, trips, torch.zeros(3), torch.zeros(3))
    counts = []
    for _ in range(dispatches):
        chain.dispatch()
        counts.append(kernel.launches)
    assert counts == [trips * (i + 1) for i in range(dispatches)]
    assert chain.captured == {kernel: trips}
    assert chain.replays == dispatches - 1
    chain.release()
    assert chain.graph is None


def test_a_capture_that_launches_nothing_counts_nothing(fake_cuda):
    graph = pgraphs.Graph(lambda: None)
    for _ in range(3):
        graph.dispatch()
    assert fake_cuda.launches == 0 and graph.captured == {}


def test_convergence_round_counts_its_steps(fake_cuda):
    kernel = fake_cuda

    def step(src, out):
        kernel()
        return torch.mul(src, 0.5, out=out)

    rnd = pdist.ConvergenceRound(step, 4, torch.ones(5), torch.ones(5))
    rnd.dispatch()
    assert kernel.launches == 4
    rnd.dispatch()
    rnd.dispatch()
    assert kernel.launches == 12 and rnd.captured == {kernel: 4}


def _adder(kernel):
    def step(src, out):
        kernel()
        return torch.add(src, 1, out=out)
    return step


def test_cached_chains_share_one_pair_of_buffers(fake_cuda):
    """Two chains of one cache (the slope's two loop lengths) run over the
    cache's one pair of buffers; each result is a copy, the block is only
    read, and release frees the graphs and drops the buffers."""
    step = _adder(fake_cuda)
    block = torch.zeros(4)
    graphs = {}

    def chain(trips):
        return lambda x, y: pdist.GraphChain(step, trips, x, y)

    got = [pdist._replay(graphs, ("a",), chain(3), block, 1),
           pdist._replay(graphs, ("b",), chain(2), block, 1),
           pdist._replay(graphs, ("a",), chain(3), block, 1)]
    # a first dispatch runs the chain and the stand-in capture runs it
    # again; the stand-in replay runs nothing, so the seed comes back
    assert [g.tolist() for g in got] == [[6.0] * 4, [4.0] * 4, [0.0] * 4]
    assert torch.equal(block, torch.zeros(4))
    a, b = graphs[("a",)], graphs[("b",)]
    assert a.x is b.x and a.y is b.y and got[0] is not a.x
    assert (a.replays, b.replays, len(graphs)) == (1, 0, 3)
    pdist.release_graphs(graphs)
    assert graphs == {} and a.graph is None and b.graph is None


@pytest.mark.parametrize("n,captures,value", [(1, 0, 2.0), (3, 1, 4.0)])
def test_a_run_without_a_cache_captures_only_what_it_replays(
        fake_cuda, monkeypatch, n, captures, value):
    """``graphs=None``: one dispatch runs eagerly (a capture of it would
    never replay); more are captured once (the stand-in capture runs the
    chain a second time), replayed and freed."""
    made = []

    class Graph(_Graph):
        def __init__(self):
            made.append(self)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    got = pdist._replay(None, ("k",), lambda x, y: pdist.GraphChain(
        _adder(fake_cuda), 2, x, y), torch.zeros(2), n)
    assert len(made) == captures
    assert fake_cuda.launches == 2 * n
    assert got.tolist() == [value, value]


DOT = """digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="solid" shape="rectangle" label="0
void jacobi_block<float>(float const*, float*)
<<<(64,1,1),(256,1,1)>>>"];
"graph_1_node_1"[style="solid" shape="record" label="{KERNEL | {name |
_Z22ncclDevKernel_SendRecvP11ncclDevComm}}"];
"graph_1_node_2"[style="solid" shape="rectangle" label="2
void ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"];
"graph_1_node_3"[style="solid" shape="rectangle" label="3
void my_ncclDevKernel_copy(float*)"];
"graph_1_node_0" -> "graph_1_node_1";
"graph_1_node_1" -> "graph_1_node_2" [headport="in"];
}
}
"""


@pytest.mark.parametrize("prefix,want", [
    ("ncclDevKernel", 2), ("jacobi_block", 1), ("pack_faces", 0)])
def test_kernel_nodes_are_counted_on_the_graphs_dot_dump(prefix, want):
    """Nodes counted once each, the name demangled or mangled, never a
    name that only ends in the prefix, and edges counted as no node."""
    assert pgraphs.count_kernel_nodes(DOT, prefix) == want


def test_a_dump_without_nodes_is_refused():
    with pytest.raises(RuntimeError, match="holds no node"):
        pgraphs.count_kernel_nodes("digraph dot {\n}\n", "ncclDevKernel")


def test_convergence_of_no_round_returns_the_block():
    with launch.process_group("gloo"):
        dec = Decomposition(make_cart_mesh(1), (16,))
        block = torch.arange(16.0)
        out, it, res = pdist.run_distributed_to_convergence(
            block, dec, 1e-3, 0)
    assert torch.equal(out, block) and out is not block
    assert (it, res) == (0, float("inf"))


# ------------------------------------------------------ rows

@pytest.mark.parametrize("kw,want", [
    ({"iters": 20}, [20, 60]),
    ({"iters": 100}, [50, 60]),
    ({"iters": 64}, [64, 64]),
    ({"iters": 96, "impl": "multi", "t_steps": 4}, [96, 144]),
    ({"iters": 8, "impl": "multi", "t_steps": 8}, [8, 24]),
    ({"iters": 8, "impl": "overlap", "halo_width": 2}, [8, 24]),
    ({"iters": 40, "fuse_steps": 5}, [5]),
])
def test_graph_steps_of_a_card_row(kw, want):
    cfg = pstencil.StencilConfig(mesh=(1, 1), dim=2, **kw)
    assert pstencil.graph_steps(cfg) == want


def test_dispatch_fields_say_how_a_row_ran():
    assert pstencil._dispatch_fields(torch.device("cpu"), [20, 60]) == {
        "dispatch": "eager"}
    assert pstencil._dispatch_fields(torch.device("cuda", 0), [20, 60]) == {
        "dispatch": "graph", "graph_steps": [20, 60]}


# ------------------------------------------------- a bench's timed loop

def test_graph_loop_on_the_cpu_chains_the_calls_eagerly():
    x0 = torch.zeros(3)
    loop = pgraphs.GraphLoop(lambda x: x + 1, x0)
    assert loop.dispatch == "eager"
    for k in (1, 5, 130):
        assert torch.equal(loop.run(k), torch.full((3,), float(k)))
    assert torch.equal(x0, torch.zeros(3)) and loop.graphs == {}


def test_graph_loop_keeps_a_graph_a_chunk_length(fake_cuda, monkeypatch):
    """On the card a run of k calls replays the graph of graph_chunk(k)
    calls k / chunk times, from the buffer seeded with x0; one graph a
    chunk length, kept across runs until released."""
    monkeypatch.setattr(pgraphs.GraphLoop, "dispatch", "graph")
    calls = []

    def body(x):
        calls.append(1)
        return x + 1

    loop = pgraphs.GraphLoop(body, torch.zeros(3))
    loop.run(10)
    loop.run(30)
    loop.run(130)
    assert sorted(loop.graphs) == [10, 26, 30]
    assert loop.graphs[26].replays == 130 // 26 - 1
    before = len(calls)
    loop.run(30)  # replays only: the stand-in graph runs nothing
    assert len(calls) == before and loop.graphs[30].replays == 1
    loop.release()
    assert loop.graphs == {} and loop.buf is None
