"""The halo-exchange bandwidth sweep and the deep-halo crossover sweep
(port of ``tpu_comm/bench/halosweep.py``).

``halo`` (:func:`run_halo_sweep`) measures the first headline metric,
halo-exchange GB/s per rank, on its own: for each local block size, run
chained ghost exchanges (``comm.halo.exchange_ghosts``, the exchange the
stencil step posts) over a 1/2/3-D Cartesian mesh of ranks and report
the bytes each rank sends a step over the step's time (both directions,
every axis; an axis of one rank moves nothing, so on one card the rate
is 0.0 and ``secs_per_iter`` is what the self-exchange costs).

Chaining: each step folds the received ghosts into the block's edge
cells, ``(edge + ghost) * 0.5`` in the field's dtype, axis by axis, so
every transfer's result feeds the next step. The fold touches only face
cells, in place: O(surface), as the transfer is. The loop is a Python
loop of bodies (JAX's is a ``fori_loop``), timed by the slope between
two loop lengths, so the carry's first copy cancels.

``halosweep`` (:func:`run_deep_halo_sweep`) runs the same distributed
stencil at every ``--halo-width`` of a list (each row under its own
``halo_width``) and fits the two-term crossover model
(:func:`fit_crossover_model`): a cost a cell update times the window's
cells, plus a cost a message times the messages, per step.

Ranks are started as the collective sweep starts them
(``comm.launch.run_world``: a world of one in process, a launcher's
group, or spawned children); rank 0 returns the rows. The default mesh
is ``topo.factor_mesh`` of the world. The JAX package also books bytes
with its obs layer (``note_bytes``); the port has none yet.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from tpu_comm_torch.bench.timing import emit_jsonl, time_loop_per_iter
from tpu_comm_torch.comm import halo, patterns


@dataclass
class HaloSweepConfig:
    dim: int = 3
    backend: str = "cuda"
    # ranks per axis; None = topo.factor_mesh of the world
    mesh: tuple[int, ...] | None = None
    dtype: str = "float32"
    width: int = 1
    # the ghosts cross in this narrower dtype and widen on receipt; None
    # = the field's dtype
    halo_wire: str | None = None
    min_bytes: int = 1 << 14       # 16 KB a rank's block
    max_bytes: int = 1 << 26       # 64 MB a rank's block
    iters: int = 20
    warmup: int = 2
    reps: int = 5
    periodic: bool = True          # closed ring: every edge transfers
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


def _local_shape(block_bytes: int, dim: int, itemsize: int,
                 width: int) -> tuple[int, ...]:
    """Near-cubic local block of ~block_bytes, every dim >= 2*width, the
    last one cut to a multiple of 128 when it is that long."""
    elems = max(block_bytes // itemsize, (2 * width) ** dim)
    side = max(int(round(elems ** (1.0 / dim))), 2 * width)
    shape = [side] * dim
    if shape[-1] >= 128:
        shape[-1] = (shape[-1] // 128) * 128
    return tuple(shape)


def halo_body(u: torch.Tensor, cart, width: int,
              wire=None) -> torch.Tensor:
    """One step of the chained loop, in place on ``u`` (the loop's own
    carry): exchange every axis' ghosts from the raw block, then fold
    each axis' into its edge cells, axis by axis, ``(edge + ghost) *
    0.5`` in the field's dtype (an add rounded to it, then an exact
    halving), as JAX's ``_halo_loop``."""
    base = u.untyped_storage().data_ptr()
    # gloo's wrap onto the own rank hands back the opposite edge itself:
    # keep the raw block's values before the first fold writes over them
    ghosts = [
        (a, *(g.clone() if g.untyped_storage().data_ptr() == base else g
              for g in (lo, hi)))
        for a, lo, hi in halo.exchange_ghosts(u, cart, width=width,
                                              wire_dtype=wire)
    ]
    for array_axis, lo, hi in ghosts:
        n = u.shape[array_axis]
        for ghost, start in ((lo, 0), (hi, n - width)):
            u.narrow(array_axis, start, width).add_(ghost).mul_(0.5)
    return u


def halo_loop(x: torch.Tensor, cart, iters: int, width: int,
              wire=None) -> torch.Tensor:
    """``iters`` chained :func:`halo_body` steps from ``x`` (only read)."""
    u = x.clone()
    for _ in range(iters):
        u = halo_body(u, cart, width, wire)
    return u


def _shift(arr: np.ndarray, k: int, axis: int, periodic: bool) -> np.ndarray:
    """np.roll with zero fill when not periodic (an open edge receives
    zeros)."""
    out = np.roll(arr, k, axis=axis)
    if not periodic:
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, k) if k > 0 else slice(arr.shape[axis] + k, None)
        out[tuple(sl)] = 0.0
    return out


def halo_oracle(g: np.ndarray, mesh: tuple[int, ...],
                periodic: tuple[bool, ...], width: int,
                wire: str | None = None) -> np.ndarray:
    """One step of the chained loop on the global field ``g`` decomposed
    over ``mesh``, in NumPy: every ghost is a width-slab of the ORIGINAL
    field shifted across a block boundary (a global roll by +/- width
    restricted to the edge stripes), folded axis by axis. The shifted
    slabs are rounded to the wire with a torch cast (NumPy has no
    bfloat16)."""
    dim = g.ndim
    local = tuple(s // p for s, p in zip(g.shape, mesh))

    def onwire(arr: np.ndarray) -> np.ndarray:
        if wire is None:
            return arr
        wd = getattr(torch, wire)
        return torch.from_numpy(arr).to(wd).to(torch.float32).numpy()

    want = g.copy()
    for a, (p, s) in enumerate(zip(mesh, local)):
        lo_mask = np.zeros(g.shape, bool)
        hi_mask = np.zeros(g.shape, bool)
        sl = [slice(None)] * dim
        for b in range(p):
            sl[a] = slice(b * s, b * s + width)
            lo_mask[tuple(sl)] = True
            sl[a] = slice((b + 1) * s - width, (b + 1) * s)
            hi_mask[tuple(sl)] = True
        # a lo stripe cell receives the original cell width below it from
        # the lower neighbour's hi edge; a hi stripe the one width above
        want = np.where(
            lo_mask, (want + onwire(_shift(g, width, a, periodic[a]))) / 2,
            want,
        )
        want = np.where(
            hi_mask, (want + onwire(_shift(g, -width, a, periodic[a]))) / 2,
            want,
        )
    return want


def _verify_halo(cart, width: int, wire: str | None, device) -> None:
    """One step of the loop against :func:`halo_oracle`, on a float32
    field of ``max(4, 2*width)`` cells an axis a rank; rank 0 checks and
    every rank raises its verdict."""
    from tpu_comm_torch.bench.stencil import _collective_verdict
    from tpu_comm_torch.domain import Decomposition

    dim = len(cart.axis_names)
    local = tuple(max(4, 2 * width) for _ in range(dim))
    gshape = tuple(p * s for p, s in zip(cart.shape, local))
    g = np.random.default_rng(0).standard_normal(gshape).astype(np.float32)
    dec = Decomposition(cart, gshape)
    got = dec.gather(halo_loop(dec.scatter(g, device, torch.float32), cart,
                               1, width, wire))

    def check():
        want = halo_oracle(g, cart.shape, cart.periodic, width, wire)
        if not np.allclose(got, want, atol=1e-6, rtol=1e-7):
            raise AssertionError(
                f"halo verification FAILED: max err "
                f"{np.abs(got - want).max()}"
            )

    _collective_verdict(check, device)


def _halo_rank(cfg: HaloSweepConfig, mesh: tuple[int, ...]) -> list | None:
    """One rank's share of :func:`run_halo_sweep`: the rows on rank 0."""
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.kernels.tiling import torch_dtype
    from tpu_comm_torch.topo import get_device, make_cart_mesh

    device = get_device(cfg.backend)
    dtype = torch_dtype(cfg.dtype)
    cart = make_cart_mesh(cfg.dim, shape=mesh, periodic=cfg.periodic)
    root = cart.rank == 0

    def barrier():
        launch.barrier(device)

    if cfg.verify:
        _verify_halo(cart, cfg.width, cfg.halo_wire, device)
    wire_itemsize = (torch_dtype(cfg.halo_wire).itemsize if cfg.halo_wire
                     else dtype.itemsize)
    records = []
    for block_bytes in cfg.sizes():
        local = _local_shape(block_bytes, cfg.dim, dtype.itemsize,
                             cfg.width)
        x = torch.ones(local, dtype=dtype, device=device)

        def run_iters(k: int, x=x):
            return halo_loop(x, cart, k, cfg.width, cfg.halo_wire)

        per_iter, t_lo, _ = time_loop_per_iter(
            run_iters, cfg.iters, warmup=cfg.warmup, reps=cfg.reps,
            barrier=barrier,
        )
        del x
        resolved = per_iter > 1e-9
        wire = halo.halo_bytes_per_iter(local, cart, wire_itemsize,
                                        width=cfg.width)
        record = {
            "workload": f"halo{cfg.dim}d",
            "backend": cfg.backend,
            "platform": device.type,
            "mesh": list(cart.shape),
            "dtype": cfg.dtype,
            **({"wire_dtype": cfg.halo_wire} if cfg.halo_wire else {}),
            "width": cfg.width,
            "size": math.prod(local) * dtype.itemsize,
            "local_size": list(local),
            "iters": cfg.iters,
            "secs_per_iter": per_iter,
            "halo_bytes_per_chip_per_iter": wire,
            "halo_gbps_per_chip": (
                wire / per_iter / 1e9 if resolved else None
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


def _world(device) -> int:
    """The ranks of a run with no --mesh: the launcher's world, the group
    already up, else every CUDA device on the card, else 1 on the CPU."""
    import os

    import torch.distributed as dist

    from tpu_comm_torch.comm import launch

    if launch.under_torchrun():
        return int(os.environ["WORLD_SIZE"])
    if dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count() if device.type == "cuda" else 1


def run_halo_sweep(cfg: HaloSweepConfig) -> list[dict] | None:
    """Run the block-size sweep: one record a size (None on the ranks
    other than 0 where a launcher started this process as one of
    many)."""
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.kernels.tiling import torch_dtype
    from tpu_comm_torch.topo import factor_mesh, get_device

    if cfg.dim not in (1, 2, 3):
        raise ValueError(f"dim must be 1|2|3, got {cfg.dim}")
    if cfg.width < 1:
        raise ValueError(f"width must be >= 1, got {cfg.width}")
    if cfg.min_bytes <= 0 or cfg.min_bytes > cfg.max_bytes:
        raise ValueError(
            f"need 0 < min_bytes <= max_bytes, got "
            f"{cfg.min_bytes}...{cfg.max_bytes}"
        )
    dtype = torch_dtype(cfg.dtype)
    if cfg.halo_wire is not None and (
        torch_dtype(cfg.halo_wire).itemsize >= dtype.itemsize
    ):
        raise ValueError(
            f"--halo-wire {cfg.halo_wire} is not narrower than the "
            f"field dtype {cfg.dtype}; drop the flag"
        )
    device = get_device(cfg.backend)
    if cfg.mesh is None:
        mesh = factor_mesh(_world(device), cfg.dim)
    else:
        mesh = tuple(int(m) for m in cfg.mesh)
        if len(mesh) != cfg.dim:
            raise ValueError(
                f"--mesh {','.join(map(str, mesh))} has {len(mesh)} axes, "
                f"--dim is {cfg.dim}"
            )
    return launch.run_world(
        _halo_rank, math.prod(mesh), device, (cfg, mesh),
        timeout_s=cfg.dist_timeout, what=f"--mesh {mesh}",
    )


# ---------------------------------------------------------------------
# The deep-halo crossover sweep: ``halosweep``
# ---------------------------------------------------------------------

@dataclass
class DeepHaloSweepConfig:
    """The ``--halo-width`` axis as one command: the SAME distributed
    stencil at every width of ``widths`` (each row under its own
    ``halo_width``), then the fit of the crossover model."""

    dim: int = 2
    size: int | None = None
    mesh: tuple[int, ...] | None = None   # required (distributed only)
    widths: tuple[int, ...] = ()          # () = patterns.HALO_WIDTH_LADDER
    impl: str = "auto"                    # resolves to the overlap arm
    bc: str = "dirichlet"
    dtype: str = "float32"
    iters: int = 64
    fuse_steps: int | None = None         # applied to EVERY width's run
    halo_wire: str | None = None
    backend: str = "cuda"
    verify: bool = True
    warmup: int = 2
    reps: int = 3
    jsonl: str | None = None
    dist_timeout: float = 600.0


def fit_crossover_model(
    widths: list[int],
    secs_per_iter: list[float],
    local_shape: tuple[int, ...],
    mesh_shape: tuple[int, ...],
) -> dict | None:
    """Least-squares fit of ``t(k) = C * cells_per_step(k) + M *
    msgs_per_iter(k)`` over the measured rows (C prices a cell update, M
    a message). Returns the fitted costs and the model's time and best
    width, or None with fewer than two resolved rows (two unknowns)."""
    pts = [
        (w, t) for w, t in zip(widths, secs_per_iter)
        if t is not None and t > 0
    ]
    if len(pts) < 2:
        return None

    def features(w: int) -> tuple[float, float]:
        m = patterns.deep_halo_model(local_shape, mesh_shape, 1, w)
        return (
            m["compute_cells_per_window"] / w,
            m["msgs_per_chip_per_iter"],
        )

    a = np.array([features(w) for w, _ in pts])
    y = np.array([t for _, t in pts])
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    per_cell_s, per_msg_s = (max(float(c), 0.0) for c in coef)
    modeled = {
        w: per_cell_s * features(w)[0] + per_msg_s * features(w)[1]
        for w in widths
    }
    return {
        "per_cell_s": per_cell_s,
        "per_msg_s": per_msg_s,
        "modeled_secs_per_iter": modeled,
        "modeled_best_width": min(modeled, key=modeled.get),
    }


def _deep_rank(cfgs: list) -> list | None:
    """One rank's share of :func:`run_deep_halo_sweep`: the stencil run
    of every width, in one process group; the rows on rank 0."""
    from tpu_comm_torch.bench.stencil import run_rank

    rows = [run_rank(c) for c in cfgs]
    return None if rows[0] is None else rows


def run_deep_halo_sweep(cfg: DeepHaloSweepConfig
                        ) -> tuple[list[dict], dict] | None:
    """One measured row a halo width (every width validated before the
    first runs), then the crossover summary: ``(records, summary)``, or
    None on the ranks other than 0 under a launcher. The summary's
    ``tuned_table_width`` is null: the port has no tuned table yet."""
    from tpu_comm_torch.bench.stencil import (
        DEFAULT_SIZES,
        StencilConfig,
        _validate_distributed,
    )
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.topo import get_device

    if cfg.mesh is None:
        raise ValueError(
            "--mesh is required: the deep-halo crossover is a "
            "distributed measurement (a single device exchanges no "
            "ghost zone to deepen)"
        )
    size = cfg.size if cfg.size else DEFAULT_SIZES[cfg.dim]
    if any(size % m for m in cfg.mesh):
        raise ValueError(
            f"--size {size} must divide by every --mesh axis {cfg.mesh}"
        )
    min_local = min(size // m for m in cfg.mesh)
    widths = tuple(cfg.widths) or patterns.HALO_WIDTH_LADDER
    for w in widths:
        if not isinstance(w, int) or w < 1:
            raise ValueError(f"--widths values must be >= 1, got {w}")
        if cfg.iters % w != 0:
            raise ValueError(
                f"--iters ({cfg.iters}) must be a multiple of every "
                f"--widths value (got {w})"
            )
        if w > min_local:
            raise ValueError(
                f"--widths value {w} exceeds the smallest local "
                f"extent {min_local} (--size {size} over --mesh "
                f"{cfg.mesh}); no axis can source a width-{w} ghost "
                f"zone"
            )
        if cfg.fuse_steps is not None and (
            w > cfg.fuse_steps or cfg.fuse_steps % w != 0
        ):
            raise ValueError(
                f"--widths value {w} does not tile the --fuse-steps "
                f"({cfg.fuse_steps}) dispatch into whole windows"
            )
    if len(set(widths)) != len(widths):
        raise ValueError(f"--widths has duplicates: {widths}")

    base = StencilConfig(
        dim=cfg.dim, size=size, mesh=cfg.mesh, iters=cfg.iters,
        dtype=cfg.dtype, bc=cfg.bc, impl=cfg.impl,
        fuse_steps=cfg.fuse_steps, halo_wire=cfg.halo_wire,
        backend=cfg.backend, verify=cfg.verify, warmup=cfg.warmup,
        reps=cfg.reps, jsonl=cfg.jsonl, dist_timeout=cfg.dist_timeout,
    )
    cfgs = [_validate_distributed(dataclasses.replace(base, halo_width=w))
            for w in widths]
    device = get_device(cfg.backend)
    records = launch.run_world(
        _deep_rank, math.prod(cfgs[0].mesh), device, (cfgs,),
        timeout_s=cfg.dist_timeout, what=f"--mesh {cfgs[0].mesh}",
    )
    if records is None:
        return None

    local = tuple(records[0]["local_size"])
    mesh_shape = tuple(records[0]["mesh"])
    measured = {
        r["halo_width"]: r.get("secs_per_iter") for r in records
    }
    resolved = {
        w: t for w, t in measured.items() if t is not None and t > 0
    }
    model = fit_crossover_model(
        list(widths), [measured[w] for w in widths], local, mesh_shape,
    )
    summary = {
        "mode": "halosweep",
        "workload": records[0]["workload"],
        "impl": records[0]["impl"],
        "dtype": cfg.dtype,
        "bc": cfg.bc,
        "mesh": list(mesh_shape),
        "size": records[0]["size"],
        "iters": cfg.iters,
        **(
            {"fuse_steps": cfg.fuse_steps}
            if cfg.fuse_steps is not None else {}
        ),
        "widths": list(widths),
        "measured_secs_per_iter": measured,
        "measured_best_width": (
            min(resolved, key=resolved.get) if resolved else None
        ),
        "redundant_compute_frac": {
            r["halo_width"]: r.get("redundant_compute_frac", 0.0)
            for r in records
        },
        "crossover_model": model,
        "verified": all(r.get("verified") for r in records),
        # the port has no tuned table (ROADMAP queue A); JAX reports what
        # its table recommends here
        "tuned_table_width": None,
    }
    return records, summary
