"""Jacobi stencil driver, on one device and across a rank mesh (port of
``tpu_comm/bench/stencil.py`` ``run_single_device`` and
``run_distributed_bench``).

Parse a config, initialise the field (or ``--load`` it), optionally
check the kernels against the serial NumPy golden, time the relaxation
loop by slope, and report one JSON row with GB/s and iterations/s. The
loop is a Python loop of one kernel launch per step (``kernels.run``),
or with ``--tol`` the convergence loop.

With ``--mesh`` the field is decomposed over a Cartesian mesh of ranks,
one process each (``comm/launch.py`` starts them), and every step
exchanges ghost cells (``kernels/distributed.py``). Every rank builds
the same initial field and takes its own block; rank 0 gathers the
field, checks it and writes the one row, and its verdict is broadcast
so that every rank fails together.

Arm names are the port's own (``bench/__init__.py`` ``STENCIL_IMPLS``
maps the JAX names); a JAX name is refused with the port's name for it.

Rows keep the JAX driver's identity fields (``workload``, ``impl``,
``backend``, ``platform``, ``dtype``, ``bc``, ``size``, ``iters``, ...),
so one reader serves both packages' rows.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np

from tpu_comm_torch.bench import JAX_STENCIL_IMPLS
from tpu_comm_torch.bench.timing import (
    emit_jsonl,
    sync,
    time_fn,
    time_loop_per_iter,
)
from tpu_comm_torch.kernels import reference, stencil_module
from tpu_comm_torch.kernels.tiling import (
    from_numpy_field,
    numpy_dtype,
    to_numpy_field,
    torch_dtype,
)

#: default global points per dimension (the JAX driver's defaults)
DEFAULT_SIZES = {1: 1 << 20, 2: 4096, 3: 256}
#: the single-device arms; ``auto`` resolves to ``stream``
IMPLS = ("stream", "block")
#: the arms of a mesh run; ``auto`` resolves to ``overlap``
DIST_IMPLS = ("torch", "overlap", "block", "stream")
#: the JAX driver's other arms, refused until a later slice ports them
UNPORTED_IMPLS = (
    "pallas-grid", "pallas-stream2", "pallas-wave", "pallas-multi",
    "partitioned", "multi",
)


@dataclass
class StencilConfig:
    dim: int = 1
    size: int = 1 << 20  # global points per dimension
    iters: int = 100
    dtype: str = "float32"
    bc: str = "dirichlet"
    # "auto" resolves to "stream" (the only arm ported so far)
    impl: str = "auto"
    # rows per CUDA block (1D: rows of 128 elements; 2D: rows of a
    # 32-column strip) or z-planes per block (3D); None = the kernel's
    # default. It sets the launch grid, never the result.
    chunk: int | None = None
    # ranks per mesh axis; None = one device, no process group
    mesh: tuple[int, ...] | None = None
    # ghost pack of a 3D mesh run: "fused" (slice copies) or "kernel"
    pack: str = "fused"
    # seconds a collective, a rendezvous or the spawned ranks may take
    dist_timeout: float = 600.0
    backend: str = "cuda"
    verify: bool = False
    verify_iters: int = 50
    # convergence mode: iterate until the per-step L2 residual reaches
    # tol, checking every check_every steps; iters is then the cap
    tol: float | None = None
    check_every: int = 10
    warmup: int = 3
    reps: int = 10
    jsonl: str | None = None
    load: str | None = None  # start from this .npy instead of init_field
    dump: str | None = None  # write the post-run field state here

    @property
    def global_shape(self) -> tuple[int, ...]:
        return (self.size,) * self.dim


def resolve_impl(impl: str, distributed: bool = False) -> str:
    """``auto`` -> ``stream`` on one device and ``overlap`` on a mesh (the
    JAX driver's choice there); a JAX arm name, an arm not yet ported, an
    arm of the other mode or an unknown name raises ValueError."""
    impls = DIST_IMPLS if distributed else IMPLS
    if impl == "auto":
        return "overlap" if distributed else "stream"
    if impl in impls:
        return impl
    if impl in JAX_STENCIL_IMPLS:
        raise ValueError(
            f"--impl {impl} is the JAX package's name; the port calls this "
            f"arm {JAX_STENCIL_IMPLS[impl]!r}"
        )
    if impl in UNPORTED_IMPLS:
        raise ValueError(
            f"--impl {impl} is not yet ported; see ROADMAP.md (ported: "
            f"{', '.join(('auto',) + impls)})"
        )
    if impl in DIST_IMPLS:
        raise ValueError(
            f"--impl {impl} is an arm of a mesh run: pass --mesh (one "
            f"device has {', '.join(('auto',) + IMPLS)})"
        )
    raise ValueError(
        f"--impl must be one of {('auto',) + impls}, got {impl!r}"
    )


def _initial_field(cfg: StencilConfig, host_dtype: np.dtype) -> np.ndarray:
    if cfg.load is None:
        return reference.init_field(cfg.global_shape, dtype=host_dtype)
    u0 = np.load(cfg.load)
    if u0.shape != cfg.global_shape:
        raise ValueError(
            f"--load {cfg.load}: shape {u0.shape} != global {cfg.global_shape}"
        )
    return np.ascontiguousarray(u0, dtype=host_dtype)


def stencil_bytes_per_iter(shape: tuple[int, ...], itemsize: int) -> int:
    """DRAM traffic model of one step: read the field once and write it
    once (neighbour reuse stays on chip); the JAX driver's accounting."""
    return 2 * int(np.prod(shape)) * itemsize


def check_against_golden(
    got: np.ndarray, want: np.ndarray, dtype: str, iters: int = 0
) -> None:
    """The JAX driver's verification envelope. float32: bitwise-grade
    (``1e-6`` or one f32 ulp per iteration of the field's scale). A
    sub-fp32 field and its golden round at different points, so the error
    is a relative unit roundoff accumulating at most once per iteration,
    still far below a wrong-neighbour bug."""
    eps = {"bfloat16": 2.0 ** -9, "float16": 2.0 ** -11}
    scale = float(np.abs(want.astype(np.float64)).max()) or 1.0
    if dtype == "float32":
        atol = max(1e-6, 2.0 ** -23 * max(iters, 1) * scale)
    else:
        atol = max(1e-2, eps.get(dtype, 1e-2) * max(iters, 1) * scale)
    if not np.allclose(got, want, atol=atol):
        raise AssertionError(
            f"verification FAILED: max err "
            f"{np.abs(got.astype(np.float64) - want.astype(np.float64)).max()}"
        )


def _verify_convergence(cfg: StencilConfig, got: np.ndarray,
                        iters_run: int, u0: np.ndarray) -> None:
    """The device loop must stop after the same number of iterations as
    the serial golden and land on the same field."""
    want, want_iters, _ = reference.jacobi_run_to_convergence(
        u0, cfg.tol, cfg.iters, check_every=cfg.check_every, bc=cfg.bc
    )
    if iters_run != want_iters:
        raise AssertionError(
            f"verification FAILED: converged after {iters_run} iters, "
            f"serial golden after {want_iters} (tol={cfg.tol})"
        )
    check_against_golden(got, want, cfg.dtype, iters=iters_run)


def _validate(cfg: StencilConfig) -> StencilConfig:
    if cfg.dim not in (1, 2, 3):
        raise ValueError(f"--dim must be 1, 2 or 3, got {cfg.dim}")
    if cfg.size < 3:
        raise ValueError(f"--size must be >= 3, got {cfg.size}")
    if cfg.iters < 1:
        raise ValueError(f"--iters must be >= 1, got {cfg.iters}")
    if cfg.chunk is not None and cfg.chunk < 1:
        raise ValueError(f"--chunk must be >= 1, got {cfg.chunk}")
    reference.check_bc(cfg.bc)
    torch_dtype(cfg.dtype)
    cfg = dataclasses.replace(
        cfg, impl=resolve_impl(cfg.impl, distributed=cfg.mesh is not None)
    )
    if cfg.mesh is None:
        if cfg.pack != "fused":
            raise ValueError("--pack applies to a 3D mesh run: pass --mesh")
        if cfg.impl == "block" and cfg.chunk is not None:
            raise ValueError(
                "--chunk applies to --impl stream; the block kernels "
                "choose their own launch grid"
            )
    return cfg


def _convergence_fields(cfg: StencilConfig, iters_run: int, res: float,
                        t, traffic: int, halo_traffic: int = 0) -> dict:
    """The measured fields of a ``--tol`` row: whole convergence runs are
    timed (the iteration count depends on the data, so no slope)."""
    secs = t.median
    per_iter = secs / iters_run if iters_run else None
    rated = bool(per_iter and per_iter > 0)
    return {
        "tol": cfg.tol,
        "check_every": cfg.check_every,
        "max_iters": cfg.iters,
        "iters": iters_run,
        "residual": res,
        "converged": res <= cfg.tol,
        "secs": secs,
        "secs_per_iter": per_iter,
        "iters_per_s": (iters_run / secs) if secs > 0 else None,
        "gbps_eff": traffic / per_iter / 1e9 if rated else None,
        **(
            {
                "halo_bytes_per_chip_per_iter": halo_traffic,
                "halo_gbps_per_chip": (
                    halo_traffic / per_iter / 1e9 if rated else None
                ),
            }
            if halo_traffic else {}
        ),
        "verified": bool(cfg.verify),
        **t.phase_fields(),
        **{f"t_{k}": v for k, v in t.summary().items()},
    }


def _slope_fields(cfg: StencilConfig, per_iter: float, t_lo, traffic: int,
                  halo_traffic: int | None = None) -> dict:
    """The measured fields of a fixed-``--iters`` row. A loop shorter
    than the clock's noise has no measurable slope: report nulls rather
    than invent a rate."""
    resolved = per_iter > 1e-9
    return {
        "iters": cfg.iters,
        "secs": per_iter * cfg.iters,
        "secs_per_iter": per_iter,
        "iters_per_s": (1.0 / per_iter) if resolved else None,
        "gbps_eff": (traffic / per_iter / 1e9) if resolved else None,
        **(
            {
                "halo_bytes_per_chip_per_iter": halo_traffic,
                "halo_gbps_per_chip": (
                    halo_traffic / per_iter / 1e9 if resolved else None
                ),
            }
            if halo_traffic is not None else {}
        ),
        "below_timing_resolution": not resolved,
        "verified": bool(cfg.verify),
        **t_lo.phase_fields(),
        **{f"t_{k}": v for k, v in t_lo.summary().items()},
    }


def run_single_device(cfg: StencilConfig) -> dict:
    """Single-device stencil benchmark; returns (and with ``jsonl``
    appends) the result row."""
    from tpu_comm_torch.topo import get_device

    cfg = _validate(cfg)
    device = get_device(cfg.backend)
    kernels = stencil_module(cfg.dim)
    dtype = torch_dtype(cfg.dtype)
    u_dev = from_numpy_field(
        _initial_field(cfg, numpy_dtype(dtype)), device, dtype
    )
    # the golden starts from the field as the device holds it (a bf16
    # field is rounded on its way there)
    u0 = to_numpy_field(u_dev)
    key = "planes_per_chunk" if cfg.dim == 3 else "rows_per_chunk"
    if cfg.impl == "block":
        # the block kernels take no chunk, and their rows carry none
        kwargs, chunk_fields = {}, {}
    else:
        if cfg.chunk is None:
            chunk = kernels.default_chunk(cfg.global_shape)
            chunk_source = "auto"
        else:
            chunk, chunk_source = cfg.chunk, "user"
        kwargs = {key: chunk}
        chunk_fields = {"chunk": chunk, "chunk_source": chunk_source}
    traffic = stencil_bytes_per_iter(cfg.global_shape, u_dev.element_size())
    base = {
        "backend": cfg.backend,
        "platform": device.type,
        "mesh": [1],
        "impl": cfg.impl,
        **chunk_fields,
        "bc": cfg.bc,
        "dtype": cfg.dtype,
        "size": list(cfg.global_shape),
    }

    if cfg.tol is not None:
        def run_conv():
            return kernels.run_to_convergence(
                u_dev, cfg.tol, cfg.iters, check_every=cfg.check_every,
                bc=cfg.bc, impl=cfg.impl, **kwargs,
            )

        u_fin, iters_run, res = run_conv()
        t = time_fn(lambda: run_conv()[0], warmup=max(cfg.warmup - 1, 0),
                    reps=cfg.reps)
        record = {
            "workload": f"stencil{cfg.dim}d-conv",
            **base,
            **_convergence_fields(cfg, iters_run, res, t, traffic),
        }
        if cfg.verify:
            _verify_convergence(cfg, to_numpy_field(u_fin), iters_run, u0)
        if cfg.dump:
            np.save(cfg.dump, to_numpy_field(u_fin))
        if cfg.jsonl:
            emit_jsonl(record, cfg.jsonl)
        return record

    def run_iters(k: int):
        return kernels.run(u_dev, k, bc=cfg.bc, impl=cfg.impl, **kwargs)

    if cfg.verify:
        got = to_numpy_field(run_iters(cfg.verify_iters))
        check_against_golden(
            got, reference.jacobi_run(u0, cfg.verify_iters, bc=cfg.bc),
            cfg.dtype, iters=cfg.verify_iters,
        )
    per_iter, t_lo, _ = time_loop_per_iter(
        run_iters, cfg.iters, warmup=cfg.warmup, reps=cfg.reps
    )
    if cfg.dump:
        np.save(cfg.dump, to_numpy_field(run_iters(cfg.iters)))
    record = {
        "workload": f"stencil{cfg.dim}d",
        **base,
        **_slope_fields(cfg, per_iter, t_lo, traffic),
    }
    if cfg.jsonl:
        emit_jsonl(record, cfg.jsonl)
    return record


def _validate_distributed(cfg: StencilConfig) -> StencilConfig:
    """Every check of a mesh run that needs no process group, so a bad
    configuration fails before a rank is started."""
    from tpu_comm_torch.domain import Decomposition
    from tpu_comm_torch.kernels.distributed import make_local_step
    from tpu_comm_torch.topo import make_cart_mesh

    if cfg.chunk is not None:
        raise ValueError(
            "--chunk is a single-device tuning knob; the distributed "
            "kernels choose their own chunking"
        )
    cfg = _validate(cfg)
    mesh = tuple(int(m) for m in cfg.mesh)
    if len(mesh) != cfg.dim:
        raise ValueError(
            f"--mesh {','.join(map(str, mesh))} has {len(mesh)} axes, "
            f"--dim is {cfg.dim}"
        )
    if cfg.check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {cfg.check_every}")
    cart = make_cart_mesh(cfg.dim, shape=mesh, periodic=cfg.bc == "periodic",
                          world=math.prod(mesh), rank=0)
    Decomposition(cart, cfg.global_shape)  # divisibility
    make_local_step(cart, cfg.bc, cfg.impl, pack=cfg.pack)  # arm x pack
    return dataclasses.replace(cfg, mesh=mesh)


def _collective_verdict(check, device) -> None:
    """Run ``check()`` on rank 0 and raise its AssertionError on EVERY
    rank: the verdict is broadcast, so no rank goes on (or waits in a
    receive) after a failed verification."""
    import torch
    import torch.distributed as dist

    message = None
    if dist.get_rank() == 0:
        try:
            check()
        except AssertionError as e:
            message = str(e) or "verification FAILED"
    failed = torch.tensor([int(message is not None)], device=device)
    dist.broadcast(failed, src=0)
    if int(failed):
        raise AssertionError(
            message or "verification FAILED (the verdict of rank 0)"
        )


def run_rank(cfg: StencilConfig) -> dict | None:
    """One rank's share of a mesh run, inside the default process group
    (world size = the mesh's): returns the row on rank 0, None elsewhere.
    ``cfg`` has passed :func:`_validate_distributed`."""
    import torch.distributed as dist

    from tpu_comm_torch.comm.halo import halo_bytes_per_iter
    from tpu_comm_torch.domain import Decomposition
    from tpu_comm_torch.kernels.distributed import (
        run_distributed,
        run_distributed_to_convergence,
    )
    from tpu_comm_torch.topo import get_device, make_cart_mesh

    device = get_device(cfg.backend)
    dtype = torch_dtype(cfg.dtype)
    cart = make_cart_mesh(
        cfg.dim, shape=cfg.mesh, periodic=(cfg.bc == "periodic")
    )
    dec = Decomposition(cart, cfg.global_shape)
    u_host = _initial_field(cfg, numpy_dtype(dtype))
    u_dev = dec.scatter(u_host, device, dtype)
    root = cart.rank == 0
    # the golden starts from the field as the devices hold it (a bf16
    # field is rounded on its way there)
    u0 = to_numpy_field(from_numpy_field(u_host, "cpu", dtype)) if root \
        else None
    kwargs = {"pack": cfg.pack}
    traffic = stencil_bytes_per_iter(dec.local_shape, u_dev.element_size())
    halo_traffic = halo_bytes_per_iter(
        dec.local_shape, cart, u_dev.element_size()
    )
    base = {
        "backend": cfg.backend,
        "platform": device.type,
        "mesh": list(cart.shape),
        "topo_plan": cart.plan_id,
        "impl": cfg.impl,
        "pack": cfg.pack,
        "bc": cfg.bc,
        "dtype": cfg.dtype,
        "size": list(cfg.global_shape),
        "local_size": list(dec.local_shape),
    }

    def barrier():
        if device.type == "cuda":
            dist.barrier(device_ids=[device.index])
        else:
            dist.barrier()

    def finish(record: dict, field) -> dict | None:
        if cfg.dump:
            got = dec.gather(field)
            if root:
                np.save(cfg.dump, got)
        if not root:
            return None
        if cfg.jsonl:
            emit_jsonl(record, cfg.jsonl)
        return record

    if cfg.tol is not None:
        def run_conv():
            return run_distributed_to_convergence(
                u_dev, dec, cfg.tol, cfg.iters,
                check_every=cfg.check_every, bc=cfg.bc, impl=cfg.impl,
                **kwargs,
            )

        u_fin, iters_run, res = run_conv()
        t = time_fn(lambda: run_conv()[0], warmup=max(cfg.warmup - 1, 0),
                    reps=cfg.reps, barrier=barrier)
        record = {
            "workload": f"stencil{cfg.dim}d-dist-conv",
            **base,
            **_convergence_fields(cfg, iters_run, res, t, traffic,
                                  halo_traffic),
        }
        if cfg.verify:
            got = dec.gather(u_fin)
            _collective_verdict(
                lambda: _verify_convergence(cfg, got, iters_run, u0), device
            )
        return finish(record, u_fin)

    def run_iters(k: int):
        return run_distributed(
            u_dev, dec, k, bc=cfg.bc, impl=cfg.impl, **kwargs
        )

    if cfg.verify:
        got = dec.gather(sync(run_iters(cfg.verify_iters)))
        _collective_verdict(
            lambda: check_against_golden(
                got, reference.jacobi_run(u0, cfg.verify_iters, bc=cfg.bc),
                cfg.dtype, iters=cfg.verify_iters,
            ),
            device,
        )
    per_iter, t_lo, _ = time_loop_per_iter(
        run_iters, cfg.iters, warmup=cfg.warmup, reps=cfg.reps,
        barrier=barrier,
    )
    record = {
        "workload": f"stencil{cfg.dim}d-dist",
        **base,
        **_slope_fields(cfg, per_iter, t_lo, traffic, halo_traffic),
    }
    return finish(record, run_iters(cfg.iters) if cfg.dump else None)


def run_distributed_bench(cfg: StencilConfig) -> dict | None:
    """Distributed stencil benchmark over ``cfg.mesh``: returns (and with
    ``jsonl`` appends) the row; None on the ranks other than 0 when a
    launcher started this process as one rank of many.

    With ``RANK``/``WORLD_SIZE`` in the environment (``torchrun``) the
    process joins that group. Otherwise a mesh of one rank runs in this
    process, in a group of one, and a larger mesh starts its own ranks
    (``comm.launch.run_ranks``); a rank that fails ends the whole run
    with RuntimeError within ``cfg.dist_timeout`` seconds.
    """
    import os

    import torch.distributed as dist

    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.topo import get_device

    cfg = _validate_distributed(cfg)
    device = get_device(cfg.backend)
    backend = launch.backend_for(device.type)
    world = math.prod(cfg.mesh)
    if launch.under_torchrun() and not dist.is_initialized():
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(
                f"--mesh {cfg.mesh} needs {world} ranks, the launcher "
                f"started {os.environ['WORLD_SIZE']}"
            )
        if device.type == "cuda":
            import torch

            torch.cuda.set_device(
                int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
            )
        with launch.process_group(
            backend, world, int(os.environ["RANK"]), "env://",
            cfg.dist_timeout,
        ):
            return run_rank(cfg)
    if world == 1 or dist.is_initialized():
        with launch.process_group(backend, world,
                                  timeout_s=cfg.dist_timeout):
            return run_rank(cfg)
    return launch.run_ranks(
        run_rank, world, backend, (cfg,), timeout_s=cfg.dist_timeout
    )
