"""``reshard``: the array-redistribution benchmark family (port of
``tpu_comm/bench/reshard.py``).

Measures both arms of a mesh->mesh redistribution plan
(``comm/reshard.py``: naive all-gather then re-slice, against the
sequential point-to-point decomposition of arXiv:2112.01075) with

- **modeled bytes** from the placement-aware traffic model
  (``moved_bytes``, the payload that truly changes device, and each
  arm's ``wire_bytes_per_chip``, which rates ``gbps_eff``);
- a **NumPy oracle**: redistribution is pure data movement, so every
  destination block must equal the directly re-sliced source layout
  bitwise, for any dtype and any mesh pair (compared as bit patterns:
  NumPy has no bfloat16);
- **peak live memory** next to GB/s: the model's ``peak_live_bytes``
  and, on the card, ``peak_live_bytes_measured``: the most the caching
  allocator held above what it held just before one eager forward
  reshard (``torch.cuda.max_memory_allocated``). JAX's row carries
  XLA's estimate ``peak_live_bytes_xla`` instead; the CPU row carries
  neither.

One process a rank over the plan's union world (``comm/launch.py``
``run_world``). The timed loop chains round trips (src->dst->src) so
the carried block keeps one shape and no transfer's result is dead; one
iteration is two reshards. ``secs_per_reshard`` is per reshard;
``gbps_eff`` rates the round trip's paired wire bytes (forward and
reverse, which differ on asymmetric mesh pairs) over the round-trip
time. JAX's loop is one ``fori_loop`` dispatch; on the card each timed
loop replays CUDA graphs of round trips (``kernels/graphs.py``
``GraphLoop``), on the CPU it runs eagerly. A lost slope is timed again
with a loop 4x longer, up to ``bench/sweep.py`` :data:`SLOPE_RETRIES`
times, every rank alike, as the sweep does; the row's ``iters`` is the
loop that was kept. Not ported: the obs span and byte counter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_comm_torch.bench.sweep import SLOPE_RETRIES, _lost_on_any_rank
from tpu_comm_torch.bench.timing import emit_jsonl, time_loop_per_iter
from tpu_comm_torch.comm import reshard as rs

#: default global edge per ndim (the JAX package's)
RESHARD_DEFAULT_SIZE = {1: 1 << 20, 2: 1024, 3: 128}

#: arm choices ("both" measures naive then sequential, one record each);
#: ``bench/__init__.py`` ``RESHARD_IMPLS`` spells it for argparse
IMPL_CHOICES = (*rs.ARMS, "both")

#: the integer type whose bit patterns stand for a dtype's in the oracle
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@dataclass
class ReshardConfig:
    src_mesh: tuple[int, ...] = (4, 1)
    dst_mesh: tuple[int, ...] = (2, 2)
    size: int | None = None           # global points per dimension
    dtype: str = "float32"
    impl: str = "both"
    # "cuda" (the card) or "cpu"; JAX's "auto" picks a TPU where it can
    backend: str = "cuda"
    iters: int = 10
    warmup: int = 2
    reps: int = 5
    verify: bool = True
    jsonl: str | None = None

    @property
    def ndim(self) -> int:
        return len(self.src_mesh)

    @property
    def global_shape(self) -> tuple[int, ...]:
        size = self.size or RESHARD_DEFAULT_SIZE.get(self.ndim)
        if size is None:
            raise ValueError(
                f"no default size for ndim {self.ndim}; pass --size"
            )
        return (size,) * self.ndim


def _host_field(gshape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """Deterministic, position-coded source field on the host: every
    element's value encodes its global index (mod the dtype's exactly
    representable range), so a block landing at the wrong destination
    offset cannot collide with the right value. The JAX package's values
    and bits (int32 indices narrowed by torch, as ``astype`` narrows
    them)."""
    n = rs._prod(gshape)
    mod = 2048 if dtype.itemsize < 4 else (1 << 22)
    return torch.arange(n, dtype=torch.int32).remainder_(mod).to(
        dtype).reshape(gshape)


def _bits(t: torch.Tensor) -> np.ndarray:
    """``t``'s bit patterns as a host NumPy integer array."""
    return t.detach().cpu().contiguous().view(_BITS[t.element_size()]).numpy()


def _verify_blocks(
    out: np.ndarray, want: list[np.ndarray], arm: str,
) -> None:
    for d, w in enumerate(want):
        if not np.array_equal(out[d], w):
            bad = int((out[d] != w).sum())
            raise AssertionError(
                f"reshard verification FAILED ({arm}): dst rank {d} "
                f"has {bad} wrong element(s) — source and destination "
                "layouts are not bitwise-equivalent"
            )


def _measured_forward(fwd, x: torch.Tensor) -> tuple[torch.Tensor, int | None]:
    """One eager forward reshard of ``x``; with it, on the card, the most
    bytes the caching allocator held during it above what it held just
    before (None on the CPU)."""
    if x.device.type != "cuda":
        return fwd(x), None
    torch.cuda.synchronize(x.device)
    torch.cuda.reset_peak_memory_stats(x.device)
    base = torch.cuda.memory_allocated(x.device)
    out = fwd(x)
    torch.cuda.synchronize(x.device)
    return out, torch.cuda.max_memory_allocated(x.device) - base


def _check(cfg: ReshardConfig):
    """JAX's checks in JAX's order; returns ``(dtype, plan, plan_rev)``."""
    from tpu_comm_torch.kernels.tiling import torch_dtype

    if cfg.impl not in IMPL_CHOICES:
        raise ValueError(
            f"--impl must be one of {IMPL_CHOICES}, got {cfg.impl!r}"
        )
    if len(cfg.src_mesh) != len(cfg.dst_mesh):
        raise ValueError(
            f"--src-mesh {cfg.src_mesh} and --dst-mesh {cfg.dst_mesh} "
            "must have the same number of axes (pad with 1s)"
        )
    dtype = torch_dtype(cfg.dtype)
    gshape = cfg.global_shape
    plan = rs.plan_reshard(gshape, cfg.src_mesh, cfg.dst_mesh,
                           dtype.itemsize)
    plan_rev = rs.plan_reshard(gshape, cfg.dst_mesh, cfg.src_mesh,
                               dtype.itemsize)
    return dtype, plan, plan_rev


def run_rank(cfg: ReshardConfig) -> list[dict] | None:
    """One rank's share of :func:`run_reshard_bench`, inside the default
    process group of ``plan.n_world`` ranks: the records on rank 0, None
    elsewhere. Every rank verifies (all of them fail together)."""
    import torch.distributed as dist

    from tpu_comm_torch.comm import collectives as coll
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.kernels.graphs import GraphLoop, graph_chunk
    from tpu_comm_torch.topo import get_device

    dtype, plan, plan_rev = _check(cfg)
    device = get_device(cfg.backend)
    rank = dist.get_rank()
    gshape = cfg.global_shape

    bits = _bits(_host_field(gshape, dtype))
    x = (torch.from_numpy(np.ascontiguousarray(
            bits[rs._block_slices(rank, cfg.src_mesh, plan.src_local)]
         )).view(dtype).to(device) if rank < plan.n_src
         else torch.zeros(plan.src_local, dtype=dtype, device=device))
    want = rs.oracle_blocks(bits, cfg.dst_mesh) if cfg.verify else None
    del bits

    def barrier():
        launch.barrier(device)

    arms = list(rs.ARMS) if cfg.impl == "both" else [cfg.impl]
    records = []
    for arm in arms:
        def fwd(u, arm=arm):
            return rs.reshard_block(u, plan, arm)

        def rev(u, arm=arm):
            return rs.reshard_block(u, plan_rev, arm)

        out, peak = _measured_forward(fwd, x)
        if cfg.verify:
            _verify_blocks(_bits(coll.all_gather(out[None])), want, arm)
        del out
        loop = GraphLoop(lambda v: rev(fwd(v)), x)
        iters = cfg.iters
        try:
            for retry in range(SLOPE_RETRIES + 1):
                per_iter, t_lo, _ = time_loop_per_iter(
                    loop.run, iters, warmup=cfg.warmup, reps=cfg.reps,
                    barrier=barrier,
                )
                resolved = per_iter / 2.0 > 1e-9
                if retry == SLOPE_RETRIES or not _lost_on_any_rank(
                        not resolved, device):
                    break
                iters *= 4
        finally:
            loop.release()
        per_reshard = per_iter / 2.0   # a round trip is two reshards
        wire = plan.wire_bytes_per_chip(arm)
        # the timed loop runs fwd AND rev, whose wire bytes differ on
        # asymmetric mesh pairs: rate the round trip against the paired
        # wire total
        wire_rt = wire + plan_rev.wire_bytes_per_chip(arm)
        record = {
            "workload": "reshard",
            "impl": arm,
            "backend": cfg.backend,
            "platform": device.type,
            "src_mesh": list(cfg.src_mesh),
            "dst_mesh": list(cfg.dst_mesh),
            "dtype": cfg.dtype,
            "size": list(gshape),
            "iters": iters,
            "secs_per_iter": per_iter,
            "secs_per_reshard": per_reshard,
            "gbps_eff": (
                wire_rt / per_iter / 1e9
                if resolved and wire_rt else None
            ),
            "moved_bytes": plan.moved_bytes,
            "wire_bytes_per_chip": wire,
            "peak_live_bytes": plan.peak_live_bytes(arm),
            **({"peak_live_bytes_measured": peak}
               if peak is not None else {}),
            "reshard_steps": plan.n_steps(arm),
            "below_timing_resolution": not resolved,
            "verified": bool(cfg.verify),
            "dispatch": loop.dispatch,
            **({"graph_steps": [graph_chunk(iters),
                                graph_chunk(3 * iters)]}
               if loop.dispatch == "graph" else {}),
            **t_lo.phase_fields(),
            **{f"t_{k}": v for k, v in t_lo.summary().items()},
        }
        if rank == 0:
            records.append(record)
            if cfg.jsonl:
                emit_jsonl(record, cfg.jsonl)
    return records if rank == 0 else None


def run_reshard_bench(cfg: ReshardConfig) -> list[dict] | None:
    """Measure the configured arm(s) over the plan's union world; one
    record per arm (None on the ranks other than 0 where a launcher
    started this process as one rank of many). Everything is checked
    before a rank starts; on the card a union world larger than the
    card count is refused (NCCL puts one rank on a device)."""
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.topo import get_device

    _, plan, _ = _check(cfg)
    device = get_device(cfg.backend)
    if device.type == "cuda" and plan.n_world > torch.cuda.device_count():
        raise ValueError(
            f"the reshard runs over a union world of {plan.n_world} ranks, "
            f"one a CUDA device, and there are "
            f"{torch.cuda.device_count()}; run it with --backend cpu"
        )
    return launch.run_world(
        run_rank, plan.n_world, device, (cfg,),
        what=f"--src-mesh {cfg.src_mesh} --dst-mesh {cfg.dst_mesh}",
    )
