"""Collective bandwidth sweep (port of ``tpu_comm/bench/sweep.py``).

The reference's MPI collective sweeps (BASELINE.json:8 "MPI Allreduce
bandwidth sweep (float32, 1KB-1GB)" and :11 "bf16/fp16 reduce-scatter +
all-gather ring vs tree; mixed-precision allreduce"). For each message
size: warmup, timed repetitions, bus-bandwidth GB/s, with the standard
bus-bandwidth factors so numbers are comparable with MPI/NCCL tables:

    allreduce (and rs+ag pair):  2(n-1)/n * bytes / t
    reduce-scatter, all-gather:    (n-1)/n * bytes / t
    ppermute / halo:                         bytes / t
    bcast:                         (n-1)/n * bytes / t

One process a rank (``comm/launch.py`` ``run_world`` starts them, as for
a mesh stencil run), each holding its own buffer of ``size`` bytes. The
timed loop is a Python loop of ``iters`` chained bodies (each body's
output is the next one's input), timed by the slope between ``iters``
and ``3 * iters`` (``bench/timing.py``), with a barrier before every
clock read, so a repetition times the slowest rank. A slope lost to the
host's noise (at or below zero: at one rank an op is tens to hundreds of
µs of Python and NCCL a call, and a loaded host can swing more between
the two loops) is timed again with a loop four times longer, up to
:data:`SLOPE_RETRIES` times, every rank alike; the row's ``iters`` is
the loop it was timed with. The stabilized forms
(``allreduce(x) / n``) keep values bounded across iterations. At world
size 1 the factors are 0 and ``gbps_bus`` is 0.0: the row still carries
``gbps_alg`` (bytes / t).

Rank 0 returns the rows; with ``jsonl`` it appends them. The JAX
package also books each size's bytes with its obs layer
(``note_bytes``); the port has no obs layer yet (ROADMAP queue A item
11).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from tpu_comm_torch.bench import SWEEP_OPS as OPS
from tpu_comm_torch.bench.timing import emit_jsonl, time_loop_per_iter
from tpu_comm_torch.comm import collectives as coll


def bus_factor(op: str, n: int) -> float:
    """Bus-bandwidth factor per BASELINE.md's measurement conventions."""
    if n <= 1:
        return 0.0
    if op in ("allreduce", "allreduce-ring", "rs-ag"):
        return 2.0 * (n - 1) / n
    if op in ("bcast", "bcast-tree"):
        return float(n - 1) / n
    if op == "ppermute":
        return 1.0
    if op == "all-to-all":
        # each rank keeps 1/n of its buffer and sends the rest
        return float(n - 1) / n
    raise ValueError(f"unknown op {op!r}")


def _loop_body(op: str, n: int, wire_dtype, acc_dtype):
    """One chained, value-stable application of the collective. The body
    owns its input (the loop's carry): ``allreduce`` reduces into it.
    Collective over the default process group, of ``n`` ranks."""
    import torch.distributed as dist

    @functools.cache
    def inv_n(dtype):
        # 1/n rounded to the buffer's dtype before the multiply, as JAX's
        # jnp.asarray(inv_n, x.dtype): a Python float would multiply by
        # 1/n unrounded and differ in bfloat16
        return torch.tensor(1.0 / n, dtype=dtype)

    def allreduce(x):
        return coll.allreduce(x, inplace=True) * inv_n(x.dtype)

    def allreduce_ring(x):
        return coll.ring_allreduce(
            x, wire_dtype=wire_dtype, acc_dtype=acc_dtype
        ) * inv_n(x.dtype)

    def rs_ag(x):
        return coll.all_gather(coll.reduce_scatter(x)) * inv_n(x.dtype)

    def ppermute(x):
        return coll.ppermute(x, coll.ring_perm(n))

    def bcast(x):
        return coll.bcast_psum(x)

    def bcast_tree(x):
        return coll.bcast_tree(x)

    def all_to_all(x):
        # full transpose: chunk j of rank i -> chunk i of rank j (the
        # Ulysses seq<->head resharding primitive); a permutation of the
        # data, so values stay bounded across chained iterations
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out

    return {
        "allreduce": allreduce,
        "allreduce-ring": allreduce_ring,
        "rs-ag": rs_ag,
        "ppermute": ppermute,
        "bcast": bcast,
        "bcast-tree": bcast_tree,
        "all-to-all": all_to_all,
    }[op]


@dataclass
class SweepConfig:
    op: str = "allreduce"
    # "cuda" (the card) or "cpu"; JAX's "auto" picks a TPU where it can
    backend: str = "cuda"
    # ranks; None = the launcher's world, else every CUDA device on the
    # card, else 1 on the CPU
    n_devices: int | None = None
    dtype: str = "float32"
    wire_dtype: str | None = None  # explicit-ring wire dtype (e.g. bfloat16)
    acc_dtype: str | None = None   # explicit-ring accumulation dtype
    # The reference's envelope is 1KB-1GB (BASELINE.json:8). Sizes are
    # PER-RANK buffer bytes; the default caps at 64 MB (the JAX
    # package's, for its CPU simulation); on the card pass
    # max_bytes=1<<30 for the full envelope.
    min_bytes: int = 1 << 10       # 1 KB
    max_bytes: int = 1 << 26       # 64 MB default; 1 GB on the card
    iters: int = 20
    warmup: int = 2
    reps: int = 5
    verify: bool = True
    jsonl: str | None = None
    # seconds a collective, the rendezvous or the spawned ranks may take
    dist_timeout: float = 600.0

    def sizes(self) -> list[int]:
        out, b = [], self.min_bytes
        while b <= self.max_bytes:
            out.append(b)
            b *= 4
        return out


#: times a row's lost slope is timed again, each loop 4x the last
SLOPE_RETRIES = 2


def _lost_on_any_rank(lost: bool, device) -> bool:
    """Whether any rank of the group lost its slope, so that every rank
    times the same loops."""
    flag = torch.tensor([int(lost)], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def sweep_input(rng, count: int, dtype: str) -> torch.Tensor:
    """``count`` standard-normal values of ``dtype`` on the host, the
    values JAX's ``_verify_op`` draws from ``rng``: NumPy has no
    bfloat16, so a bfloat16 input is the float32 draw narrowed by torch
    (round to nearest even, as JAX's ``ml_dtypes`` cast)."""
    values = rng.standard_normal((count,))
    if dtype == "bfloat16":
        return torch.from_numpy(values.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(values.astype(np.dtype(dtype)))


def _verify_op(cfg: SweepConfig, body, n: int, device, rng) -> None:
    """One small correctness pass: the chained-loop body with iters=1 must
    match the NumPy oracle for the collective. Every rank gathers the
    result and checks it, so every rank fails together."""
    import torch.distributed as dist

    from tpu_comm_torch.kernels.tiling import to_numpy_field

    per_dev = ((max(n, 8) + n - 1) // n) * n  # ring ops need n | per_dev
    host = sweep_input(rng, n * per_dev, cfg.dtype)
    rank = dist.get_rank()
    block = host[rank * per_dev:(rank + 1) * per_dev].to(device, copy=True)
    got = to_numpy_field(coll.all_gather(body(block)))
    blocks = to_numpy_field(host).reshape(n, per_dev).astype(np.float64)
    mean = blocks.mean(axis=0)
    if cfg.op in ("allreduce", "allreduce-ring", "rs-ag"):
        want = np.tile(mean, n)
    elif cfg.op == "ppermute":
        want = np.roll(blocks, 1, axis=0).reshape(-1)
    elif cfg.op in ("bcast", "bcast-tree"):
        want = np.tile(blocks[0], n)
    elif cfg.op == "all-to-all":
        # block i, chunk j  <->  block j, chunk i
        want = (
            blocks.reshape(n, n, -1).transpose(1, 0, 2).reshape(-1)
        )
    else:
        raise ValueError(cfg.op)
    tol = 1e-5 if cfg.dtype == "float32" and cfg.wire_dtype is None else 5e-2
    if not np.allclose(got.astype(np.float64), want, atol=tol, rtol=tol):
        raise AssertionError(
            f"sweep op {cfg.op} verification failed: "
            f"max err {np.abs(got - want).max()}"
        )


def run_rank(cfg: SweepConfig) -> list[dict] | None:
    """One rank's share of the sweep, inside the default process group:
    the rows on rank 0, None elsewhere."""
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.kernels.tiling import torch_dtype
    from tpu_comm_torch.topo import get_device, make_cart_mesh

    device = get_device(cfg.backend)
    cart = make_cart_mesh(1, periodic=True)
    n = cart.world
    dtype = torch_dtype(cfg.dtype)
    itemsize = dtype.itemsize
    body = _loop_body(
        cfg.op, n,
        torch_dtype(cfg.wire_dtype) if cfg.wire_dtype else None,
        torch_dtype(cfg.acc_dtype) if cfg.acc_dtype else None,
    )

    def barrier():
        launch.barrier(device)

    # every rank's communicator is up before a round that not every rank
    # takes part in (the tree's first hops)
    barrier()
    if cfg.verify:
        _verify_op(cfg, body, n, device, np.random.default_rng(0))

    root = cart.rank == 0
    records = []
    for size_bytes in cfg.sizes():
        per_dev_elems = max(size_bytes // itemsize, n)
        # leading axis must split n ways for rs/ag shapes
        per_dev_elems = ((per_dev_elems + n - 1) // n) * n
        x = torch.ones((per_dev_elems,), dtype=dtype, device=device)

        def run_iters(k: int, x=x):
            # the copy is the loop's own carry (the allreduce body writes
            # into it); a fixed cost, which the slope cancels
            y = x.clone()
            for _ in range(k):
                y = body(y)
            return y

        iters = cfg.iters
        for retry in range(SLOPE_RETRIES + 1):
            per_iter, t_lo, _ = time_loop_per_iter(
                run_iters, iters, warmup=cfg.warmup, reps=cfg.reps,
                barrier=barrier,
            )
            resolved = per_iter > 1e-9
            if retry == SLOPE_RETRIES or not _lost_on_any_rank(
                    not resolved, device):
                break
            iters *= 4
        actual_bytes = per_dev_elems * itemsize
        factor = bus_factor(cfg.op, n)
        record = {
            "workload": f"sweep-{cfg.op}",
            "backend": cfg.backend,
            "platform": device.type,
            "mesh": list(cart.shape),
            "topo_plan": cart.plan_id,
            "dtype": cfg.dtype,
            "wire_dtype": cfg.wire_dtype,
            "acc_dtype": cfg.acc_dtype,
            "size": actual_bytes,
            "iters": iters,
            "secs_per_iter": per_iter,
            "gbps_bus": (
                factor * actual_bytes / per_iter / 1e9 if resolved else None
            ),
            "gbps_alg": (
                actual_bytes / per_iter / 1e9 if resolved else None
            ),
            "below_timing_resolution": not resolved,
            "verified": bool(cfg.verify),
            **t_lo.phase_fields(),
            **{f"t_{k}": v for k, v in t_lo.summary().items()},
        }
        if root:
            records.append(record)
            if cfg.jsonl:
                emit_jsonl(record, cfg.jsonl)
    return records if root else None


def run_sweep(cfg: SweepConfig) -> list[dict] | None:
    """Run the size sweep, returning one record per message size (None on
    the ranks other than 0 where a launcher started this process as one
    rank of many). A failed rank ends the run with RuntimeError within
    ``cfg.dist_timeout`` seconds."""
    import os

    import torch.distributed as dist

    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.kernels.tiling import torch_dtype
    from tpu_comm_torch.topo import get_device

    if cfg.op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {cfg.op!r}")
    if cfg.min_bytes <= 0 or cfg.min_bytes > cfg.max_bytes:
        raise ValueError(
            f"need 0 < min_bytes <= max_bytes, got {cfg.min_bytes}..."
            f"{cfg.max_bytes}"
        )
    if (cfg.wire_dtype or cfg.acc_dtype) and cfg.op != "allreduce-ring":
        raise ValueError(
            "--wire-dtype/--acc-dtype only apply to the explicit ring "
            f"(op=allreduce-ring); op {cfg.op!r} cannot honor them"
        )
    for name in (cfg.dtype, cfg.wire_dtype, cfg.acc_dtype):
        if name is not None:
            torch_dtype(name)
    device = get_device(cfg.backend)
    world = cfg.n_devices
    if world is None:
        if launch.under_torchrun():
            world = int(os.environ["WORLD_SIZE"])
        elif dist.is_initialized():
            world = dist.get_world_size()
        else:
            world = torch.cuda.device_count() if device.type == "cuda" else 1
    if world < 1:
        raise ValueError(f"--n-devices must be >= 1, got {world}")
    return launch.run_world(
        run_rank, world, device, (cfg,),
        timeout_s=cfg.dist_timeout, what=f"--n-devices {world}",
    )
