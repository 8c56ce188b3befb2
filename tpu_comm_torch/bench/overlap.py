"""C9 verification, the ``overlap`` subcommand (port of
``tpu_comm/bench/overlap.py``): is the halo exchange overlap-capable, and
does the card run compute while a transfer is in flight?

JAX reads its proof off the compiled HLO of the step (async
``collective-permute-start``/``-done`` pairs, and the compute scheduled
between them). PyTorch has no compiled module to read, so the port reads
a ``torch.profiler`` trace of the step instead (``bench/trace.py``):

1. **P2P ops** (any device): the host ops ``c10d::send`` of one eager
   step; each pairs with a ``c10d::recv_`` (a ppermute is a send and a
   receive). That is ``n_permutes``.
2. **Device schedule** (the card): the step is run as the card runs a
   mesh run, a replay of a CUDA graph of the steps (``kernels/graphs``),
   and the trace's device kernels are read as intervals. The NCCL
   kernels (``ncclDevKernel_*``) are the transfers in flight
   (``n_async_pairs``); every other device op whose interval intersects
   an NCCL kernel's is compute that ran while a transfer flew
   (``fused_ops_between``), and those of them that are the port's own
   kernels (``csrc/``) are ``kernels_between``. Off the card there is
   no device schedule to read, so ``scheduled_overlap`` is None there, as
   JAX's is None off the TPU.

The NCCL kernels a graph holds are counted on the graph itself, its
kernel nodes (``graphs.kernel_nodes``): a trace of a replay has lost
some of them on the H100, so the trace's count is reported beside it and
no verdict rests on it.

The fused audit (``--fuse-steps N``, JAX's ``audit_fused``) checks what
a ``--fuse-steps`` run dispatches on the card: a dispatch is ONE graph
launch (``cudaGraphLaunch``), with no host P2P call or synchronisation
during it, of a graph that holds every trip's exchange (its NCCL nodes
are the trips times those of a graph of one trip); with ``--halo-width
K`` a K-step window makes the P2P ops and the NCCL nodes of one width-1
window, one exchange round a window. The interval logic
(:func:`overlapping`) is a pure function of event records.
"""

from __future__ import annotations

import functools
import math
import os
import re
import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch

from tpu_comm_torch.bench.trace import DEVICE_CATEGORIES, Event, read_events

#: the exchange arms the audit takes (JAX's lax, overlap, partitioned)
OVERLAP_IMPLS = ("torch", "overlap", "partitioned")
#: the JAX package's arm name -> the port's
JAX_OVERLAP_IMPLS = {"lax": "torch"}
#: host ops of a point-to-point transfer (gloo and NCCL alike)
SEND_OP, RECV_OP = "c10d::send", "c10d::recv_"
#: the name of every NCCL device kernel
NCCL_KERNEL = "ncclDevKernel"
#: the host runtime call that launches a CUDA graph
GRAPH_LAUNCH = "cudaGraphLaunch"
#: host runtime calls that wait for the card
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize")
#: the host span :func:`trace_region` puts around the traced call
REGION = "tpu_comm_torch.traced_region"
_CSRC = Path(__file__).resolve().parents[1] / "csrc"


@dataclass
class OverlapReport:
    platform: str
    impl: str
    n_permutes: int            # P2P ops a step (sends, each with its recv)
    n_async_pairs: int         # NCCL send/recv kernels a step
    fused_ops_between: int     # device ops intersecting an NCCL kernel
    # compute ran while a transfer was in flight, read off the card's
    # trace; None off the card, which has no device schedule to read
    scheduled_overlap: bool | None
    # the port's own kernels among fused_ops_between
    kernels_between: int = 0

    def to_dict(self) -> dict:
        return self.__dict__.copy()


@functools.cache
def port_kernel_names() -> frozenset:
    """The names of the port's own CUDA kernels (every ``__global__``
    function of ``csrc/``)."""
    pattern = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    return frozenset(
        name for src in sorted(_CSRC.glob("*.cu*"))
        for name in pattern.findall(src.read_text()))


def is_nccl(e: Event) -> bool:
    return e.cat == "kernel" and e.name.startswith(NCCL_KERNEL)


def is_port_kernel(e: Event) -> bool:
    """A kernel event of one of the port's kernels (the trace names it by
    its demangled signature, ``void name<T>(...)``)."""
    if e.cat != "kernel":
        return False
    m = re.match(r"(?:void\s+)?([A-Za-z_]\w*)", e.name)
    return m is not None and m.group(1) in port_kernel_names()


def intersects(a: Event, b: Event) -> bool:
    """The open intervals ``[ts, end)`` share time: nested or partly
    overlapping intervals do, touching or disjoint ones do not."""
    return a.ts < b.end and b.ts < a.end


def overlapping(events) -> tuple[int, int]:
    """``(ops, kernels)``: the device ops (kernels, copies, memsets) other
    than NCCL kernels whose interval intersects an NCCL kernel's, each
    counted once, and how many of them are the port's kernels."""
    nccl = [e for e in events if is_nccl(e)]
    ops = [e for e in events
           if e.cat in DEVICE_CATEGORIES and not is_nccl(e)
           and any(intersects(e, n) for n in nccl)]
    return len(ops), sum(1 for e in ops if is_port_kernel(e))


def count(events, name: str) -> int:
    return sum(1 for e in events if e.name == name)


def within(events, span: Event) -> list[Event]:
    """The events that start and end inside ``span``."""
    return [e for e in events if span.ts <= e.ts and e.end <= span.end]


def trace_region(fn, device: torch.device) -> list[Event]:
    """The events of ``fn()`` run under ``torch.profiler`` (CPU
    activities, and CUDA ones on the card), the call inside the host span
    :data:`REGION`. The card is synchronised before the trace opens, so
    no earlier work still in flight is recorded, and after the call,
    before it closes, so every device event of the call is in."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(REGION):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_events(path)
    finally:
        os.unlink(path)


def _per(total: int, n: int) -> int:
    """``total`` a step of ``n`` steps, rounded up (one op in any step
    counts)."""
    return -(-total // n)


def _block(dec, device) -> torch.Tensor:
    """A seeded random block of the rank's local shape on ``device``."""
    g = torch.Generator().manual_seed(1234 + dec.cart.rank)
    return torch.rand(dec.local_shape, generator=g).to(device)


def _p2p_ops(step, trips: int, block: torch.Tensor) -> tuple[int, list]:
    """Sends a trip of ``step`` in an eager trace of ``trips`` trips (after
    one untraced trip, which sets up the transfers), and the trace."""
    from tpu_comm_torch.kernels.distributed import _run_eager

    _run_eager(step, block, 1)
    events = trace_region(lambda: _run_eager(step, block, trips),
                          block.device)
    sends, recvs = count(events, SEND_OP), count(events, RECV_OP)
    if sends != recvs:
        raise RuntimeError(
            f"the trace holds {sends} {SEND_OP} and {recvs} {RECV_OP}: a "
            "send without its receive")
    return sends // trips, events


def _replay_events(step, trips: int, block: torch.Tensor
                   ) -> tuple[list[Event], int]:
    """The events of one replay of a graph of ``trips`` trips (captured
    after an eager warm-up, as a card run captures it), and the NCCL
    kernel nodes the graph holds."""
    from tpu_comm_torch.kernels.distributed import GraphChain
    from tpu_comm_torch.kernels.graphs import kernel_nodes

    chain = GraphChain(step, trips, torch.empty_like(block),
                       torch.empty_like(block), debug=True)
    try:
        chain.x.copy_(block)
        chain.dispatch()  # the eager warm-up, then the capture
        nodes = kernel_nodes(chain.graph, NCCL_KERNEL)
        return trace_region(chain.dispatch, block.device), nodes
    finally:
        chain.release()


def analyze_overlap(dec, bc: str = "dirichlet", impl: str = "overlap",
                    iters: int = 2, opts: tuple = (),
                    backend: str = "cuda") -> OverlapReport:
    """Run the distributed step on ``dec``'s mesh on ``backend``'s device
    (every rank calls this) and report whether the halo exchange is
    overlap-capable and, on the card, scheduled so. ``opts`` are the
    step's options (e.g. ``(("halo_parts", 4),)``)."""
    from tpu_comm_torch.kernels.distributed import make_local_step
    from tpu_comm_torch.topo import get_device

    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    device = get_device(backend)
    step = make_local_step(dec.cart, bc, impl, **dict(opts))
    block = _block(dec, device)
    n_permutes, _ = _p2p_ops(step, iters, block)
    if device.type != "cuda":
        return OverlapReport(platform=device.type, impl=impl,
                             n_permutes=n_permutes, n_async_pairs=0,
                             fused_ops_between=0, scheduled_overlap=None,
                             kernels_between=0)
    replay, nodes = _replay_events(step, iters, block)
    ops, kernels = overlapping(replay)
    return OverlapReport(
        platform=device.type, impl=impl, n_permutes=n_permutes,
        n_async_pairs=_per(nodes, iters),
        fused_ops_between=_per(ops, iters),
        scheduled_overlap=ops > 0,
        kernels_between=_per(kernels, iters),
    )


def audit_fused(dec, bc: str = "dirichlet", impl: str = "overlap",
                fuse_steps: int = 8, opts: tuple = (),
                halo_width: int | None = None,
                backend: str = "cuda") -> dict:
    """Check what a ``--fuse-steps`` run dispatches (JAX's
    ``audit_fused``, from a trace and the graph): on the card one
    dispatch is one graph launch, with no host P2P call or
    synchronisation during it, of a graph whose NCCL nodes are its trips
    (steps or windows) times those of a graph of one trip
    (``exchange_in_graph``). ``halo_width=K`` audits the deep-halo
    window: a K-step window makes the P2P ops of one width-1 window, and
    on the card a graph of it holds the NCCL nodes of one
    (``one_exchange_per_window``). Off the card a dispatch is eager
    steps: the graph fields are None."""
    from tpu_comm_torch.kernels.distributed import (
        _step_and_trips,
        make_deep_halo_window,
    )
    from tpu_comm_torch.topo import get_device

    if fuse_steps < 1:
        raise ValueError(f"fuse_steps must be >= 1, got {fuse_steps}")
    if halo_width is not None and (
        halo_width > fuse_steps or fuse_steps % halo_width != 0
    ):
        raise ValueError(
            f"halo_width={halo_width} does not tile the fuse_steps="
            f"{fuse_steps} dispatch into whole exchange-free windows; pick "
            f"halo_width <= fuse_steps with fuse_steps % halo_width == 0"
        )
    device = get_device(backend)
    step_opts = dict(opts)
    if halo_width is not None:
        step_opts["halo_width"] = halo_width
    step, trips = _step_and_trips(dec.cart, bc, impl, dict(step_opts),
                                  fuse_steps)
    block = _block(dec, device)
    per_trip, _ = _p2p_ops(step, 1, block)
    doc = {
        "impl": impl,
        "platform": device.type,
        "fuse_steps": fuse_steps,
        "n_permutes": per_trip,
        "n_executables": None,
        "n_async_pairs": 0,
        "fused_ops_between": 0,
        "kernels_between": 0,
        "exchange_in_graph": None,
        "host_roundtrips_between_steps": None,
    }
    one_nodes = None
    if device.type == "cuda":
        replay, nodes = _replay_events(step, trips, block)
        one_nodes = nodes if trips == 1 else _replay_events(step, 1, block)[1]
        ops, kernels = overlapping(replay)
        # the host's calls while it dispatched (not the trace's own
        # synchronise after it)
        (span,) = [e for e in replay
                   if e.name == REGION and e.cat == "user_annotation"]
        host_calls = within(replay, span)
        launches = count(host_calls, GRAPH_LAUNCH)
        host = sum(count(host_calls, n)
                   for n in (SEND_OP, RECV_OP, *SYNC_CALLS))
        doc.update({
            # graph launches a dispatch: one is the whole chain
            "n_executables": launches,
            "n_async_pairs": _per(nodes, trips),
            "fused_ops_between": _per(ops, trips),
            "kernels_between": _per(kernels, trips),
            # one launch, no host call during it, and every trip's
            # exchange in the graph
            "exchange_in_graph": (launches == 1 and host == 0
                                  and one_nodes > 0
                                  and nodes == trips * one_nodes),
            "host_roundtrips_between_steps": host,
            "nccl_nodes": nodes,
            "nccl_nodes_per_trip": one_nodes,
            # the trace's count, which has come out short of the graph's
            "nccl_kernels_traced": sum(1 for e in replay if is_nccl(e)),
        })
    if halo_width is None:
        return doc
    ref = make_deep_halo_window(dec.cart, bc, 1,
                                wire=step_opts.get("halo_wire"))
    ref_permutes, _ = _p2p_ops(ref, 1, block)
    ref_nodes = (None if one_nodes is None
                 else _replay_events(ref, 1, block)[1])
    doc.update({
        "halo_width": halo_width,
        "windows": fuse_steps // halo_width,
        "permutes_per_window": per_trip,
        "permutes_per_step_reference": ref_permutes,
        "nccl_nodes_per_step_reference": ref_nodes,
        "one_exchange_per_window": (per_trip > 0 and per_trip == ref_permutes
                                    and one_nodes == ref_nodes),
    })
    return doc


def round_global_shape(size: int, mesh_shape: tuple[int, ...]
                       ) -> tuple[int, ...]:
    """Round each global dim down to a mesh-divisible size (>= 4 a rank),
    as JAX's."""
    return tuple(max(size - size % p, 4 * p) for p in mesh_shape)


@dataclass
class OverlapConfig:
    dim: int = 3
    size: int | None = None        # default 64
    mesh: tuple[int, ...] | None = None
    bc: str = "dirichlet"
    impl: str = "overlap"
    fuse_steps: int | None = None
    halo_parts: int | None = None
    halo_width: int | None = None
    backend: str = "cuda"
    dist_timeout: float = 600.0


def _overlap_rank(cfg: OverlapConfig, mesh: tuple[int, ...]) -> dict | None:
    import torch.distributed as dist

    from tpu_comm_torch.domain import Decomposition
    from tpu_comm_torch.topo import make_cart_mesh

    cart = make_cart_mesh(cfg.dim, shape=mesh,
                          periodic=cfg.bc == "periodic")
    dec = Decomposition(cart, round_global_shape(cfg.size or 64, cart.shape))
    opts: tuple = ()
    if cfg.halo_parts is not None:
        opts = (("halo_parts", cfg.halo_parts),)
    if cfg.fuse_steps is not None:
        doc = audit_fused(dec, bc=cfg.bc, impl=cfg.impl,
                          fuse_steps=cfg.fuse_steps, opts=opts,
                          halo_width=cfg.halo_width, backend=cfg.backend)
    else:
        doc = analyze_overlap(dec, bc=cfg.bc, impl=cfg.impl, opts=opts,
                              backend=cfg.backend).to_dict()
    rank = dist.get_rank() if dist.is_initialized() else 0
    return doc if rank == 0 else None


def run_overlap(cfg: OverlapConfig) -> dict | None:
    """The ``overlap`` subcommand: the report (or with ``fuse_steps`` the
    fused audit) of rank 0, every rank of the mesh tracing its own step;
    None on the other ranks where a launcher started this process as one
    of many. The JAX CLI's checks and messages."""
    from tpu_comm_torch.bench.halosweep import _world
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.topo import factor_mesh, get_device

    if cfg.impl in JAX_OVERLAP_IMPLS:
        raise ValueError(
            f"--impl {cfg.impl} is the JAX package's name; the port calls "
            f"this arm {JAX_OVERLAP_IMPLS[cfg.impl]!r}"
        )
    if cfg.impl not in OVERLAP_IMPLS:
        raise ValueError(
            f"--impl must be one of {OVERLAP_IMPLS}, got {cfg.impl!r}")
    if cfg.halo_parts is not None and cfg.impl != "partitioned":
        raise ValueError("--halo-parts applies to --impl partitioned")
    if cfg.halo_width is not None and cfg.fuse_steps is None:
        raise ValueError(
            "--halo-width audits the fused deep-halo program; pass "
            "--fuse-steps N (a multiple of the width) so there is a "
            "k-step-window loop to prove"
        )
    device = get_device(cfg.backend)
    if cfg.mesh is None:
        mesh = factor_mesh(_world(device), cfg.dim)
    else:
        mesh = tuple(int(m) for m in cfg.mesh)
        if len(mesh) != cfg.dim:
            raise ValueError(
                f"--mesh must have {cfg.dim} comma-separated entries for "
                f"--dim {cfg.dim}, got {','.join(map(str, mesh))!r}"
            )
    return launch.run_world(
        _overlap_rank, math.prod(mesh), device, (cfg, mesh),
        timeout_s=cfg.dist_timeout, what=f"--mesh {mesh}",
    )
