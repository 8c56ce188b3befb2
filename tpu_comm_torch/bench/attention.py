"""Long-context attention benchmark (port of
``tpu_comm/bench/attention.py``; extras, not a parity item).

Times ring and Ulysses sequence-parallel attention
(``extras/ring_attention.py``) over a 1D ring of ranks, one process a
rank (``comm/launch.py`` ``run_world``), with the slope timing of the
other drivers. The timed loop chains q through the attention
(``q = attn(q, k, v)``) so no iteration is dead; JAX's loop is one
``fori_loop`` dispatch, and on the card each timed loop replays CUDA
graphs of iterations (``kernels/graphs.py`` ``GraphLoop``), on the CPU
it runs eagerly. Reported:

- ``tflops``: 4 * seq^2 * head_dim * heads FLOPs an iteration (QK^T and
  PV, 2 a MAC), halved for causal, where only the lower triangle of the
  score matrix is useful work;
- ``ring_gbps_per_chip`` (ring only): the bytes each rank sends around
  the ring an iteration (K and V blocks, n - 1 hops) over the time.

Not ported: the obs byte counter.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from tpu_comm_torch.bench.timing import emit_jsonl, time_loop_per_iter

IMPLS = ("ring", "ulysses")


@dataclass
class AttnConfig:
    seq: int = 4096
    heads: int = 8
    head_dim: int = 128
    impl: str = "ring"  # ring | ulysses
    causal: bool = False
    dtype: str = "float32"  # float32 | bfloat16 (Q/K/V storage + wire)
    # "cuda" (the card) or "cpu"; JAX's "auto" picks a TPU where it can
    backend: str = "cuda"
    # ranks; None = the launcher's world, else every CUDA device on the
    # card, else 1 on the CPU
    n_devices: int | None = None
    iters: int = 10
    warmup: int = 2
    reps: int = 5
    verify: bool = True
    jsonl: str | None = None


def _attn_flops(cfg: AttnConfig) -> float:
    full = 4 * cfg.seq * cfg.seq * cfg.head_dim * cfg.heads
    # causal: only the lower triangle of the seq x seq score matrix is
    # useful work, half the MACs (the flash-attention convention)
    return full / 2 if cfg.causal else full


def _world(cfg: AttnConfig, device: torch.device) -> int:
    """The ranks of the run, as ``sweep`` picks them."""
    import torch.distributed as dist

    from tpu_comm_torch.comm import launch

    n = cfg.n_devices
    if n is None:
        if launch.under_torchrun():
            n = int(os.environ["WORLD_SIZE"])
        elif dist.is_initialized():
            n = dist.get_world_size()
        else:
            n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n < 1:
        raise ValueError(f"--n-devices must be >= 1, got {n}")
    return n


def _check(cfg: AttnConfig, n: int) -> None:
    """JAX's checks after the impl's, in JAX's order."""
    if cfg.seq % n != 0:
        raise ValueError(f"seq {cfg.seq} not divisible by {n} devices")
    if cfg.heads % n != 0:
        raise ValueError(f"heads {cfg.heads} not divisible by {n} devices")
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"dtype must be float32|bfloat16, got {cfg.dtype!r}")


def attention_inputs(cfg: AttnConfig) -> tuple[torch.Tensor, ...]:
    """JAX's q, k, v on the host: ``default_rng(0)`` standard normals of
    shape (seq, heads, head_dim), float32, narrowed to the dtype by torch
    (bfloat16 rounds to nearest even, as JAX's cast)."""
    from tpu_comm_torch.kernels.tiling import torch_dtype

    rng = np.random.default_rng(0)
    shape = (cfg.seq, cfg.heads, cfg.head_dim)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            torch_dtype(cfg.dtype))
        for _ in range(3)
    )


def run_rank(cfg: AttnConfig) -> dict | None:
    """One rank's share of :func:`run_attention_bench`, inside the
    default process group: the record on rank 0, None elsewhere. Every
    rank verifies (all of them fail together)."""
    import torch.distributed as dist

    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.extras import ring_attention as ra
    from tpu_comm_torch.kernels.graphs import GraphLoop, graph_chunk
    from tpu_comm_torch.topo import get_device

    device = get_device(cfg.backend)
    n, rank = dist.get_world_size(), dist.get_rank()
    host = attention_inputs(cfg)
    per = cfg.seq // n
    qd, kd, vd = (x[rank * per:(rank + 1) * per].to(device) for x in host)
    fn = ra.ring_attention if cfg.impl == "ring" else ra.ulysses_attention

    def attn(q):
        return fn(q, kd, vd, causal=cfg.causal)

    if cfg.verify:
        out = attn(qd)
        blocks = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(blocks, out)
        got = torch.cat(blocks).float().cpu().numpy()
        # the golden takes the same (possibly bf16-rounded) inputs the
        # ranks hold, so the tolerance covers accumulation only
        want = ra.reference_attention(*(x.float().numpy() for x in host),
                                      causal=cfg.causal)
        tol = 5e-4 if cfg.dtype == "float32" else 2e-2
        if not np.allclose(got, want, atol=tol, rtol=tol):
            raise AssertionError(
                f"attention verification failed: max err "
                f"{np.abs(got - want).max()}"
            )
        del out, blocks

    def barrier():
        launch.barrier(device)

    loop = GraphLoop(attn, qd)
    try:
        per_iter, t_lo, _ = time_loop_per_iter(
            loop.run, cfg.iters, warmup=cfg.warmup, reps=cfg.reps,
            barrier=barrier,
        )
    finally:
        loop.release()
    resolved = per_iter > 1e-9
    itemsize = qd.element_size()
    # ring wire traffic per rank an iteration: K and V blocks, n-1 hops
    ring_bytes = (
        2 * per * cfg.heads * cfg.head_dim * itemsize * (n - 1)
        if cfg.impl == "ring" else None
    )
    record = {
        "workload": f"attention-{cfg.impl}",
        "backend": cfg.backend,
        "platform": device.type,
        "mesh": [n],
        "dtype": cfg.dtype,
        "causal": cfg.causal,
        "size": [cfg.seq, cfg.heads, cfg.head_dim],
        "iters": cfg.iters,
        "secs_per_iter": per_iter,
        "tflops": (_attn_flops(cfg) / per_iter / 1e12) if resolved else None,
        "ring_bytes_per_chip_per_iter": ring_bytes,
        "ring_gbps_per_chip": (
            ring_bytes / per_iter / 1e9
            if resolved and ring_bytes is not None else None
        ),
        "below_timing_resolution": not resolved,
        "verified": bool(cfg.verify),
        "dispatch": loop.dispatch,
        **({"graph_steps": [graph_chunk(cfg.iters),
                            graph_chunk(3 * cfg.iters)]}
           if loop.dispatch == "graph" else {}),
        **t_lo.phase_fields(),
        **{f"t_{k}": v for k, v in t_lo.summary().items()},
    }
    if rank != 0:
        return None
    if cfg.jsonl:
        emit_jsonl(record, cfg.jsonl)
    return record


def run_attention_bench(cfg: AttnConfig) -> dict | None:
    """Time the configured attention over ``n_devices`` ranks; the record
    (None on the ranks other than 0 where a launcher started this process
    as one rank of many). Everything is checked before a rank starts."""
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.topo import get_device

    if cfg.impl not in IMPLS:
        raise ValueError(f"impl must be ring|ulysses, got {cfg.impl!r}")
    device = get_device(cfg.backend)
    n = _world(cfg, device)
    _check(cfg, n)
    return launch.run_world(run_rank, n, device, (cfg,),
                            what=f"--n-devices {n}")
