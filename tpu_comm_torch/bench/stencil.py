"""Jacobi stencil driver, on one device and across a rank mesh (port of
``tpu_comm/bench/stencil.py`` ``run_single_device`` and
``run_distributed_bench``).

Parse a config, initialise the field (or ``--load`` it), optionally
check the kernels against the serial NumPy golden, time the relaxation
loop by slope, and report one JSON row with GB/s and iterations/s. The
loop is a Python loop of one kernel launch per step (``kernels.run``),
with ``--impl multi`` one launch per ``--t-steps`` steps
(``kernels.run_multi``, temporal blocking), or with ``--tol`` the
convergence loop. ``--points 9`` (2D) and
``--points 27`` (3D) run the box stencils instead of the star, as their
own workloads (``stencil2d-9pt``, ``stencil3d-27pt``). With
``--profile DIR`` the timed loop (a ``--tol`` run: its first run and its
timed runs, as JAX's) runs under ``torch.profiler`` and each rank writes
``DIR/rank<r>.json`` (``bench/trace.py``); the row is unchanged.

With ``--mesh`` the field is decomposed over a Cartesian mesh of ranks,
one process each (``comm/launch.py`` starts them), and every step
exchanges ghost cells (``kernels/distributed.py``); ``--impl multi``
exchanges width-``t_steps`` ghosts once per ``t_steps`` steps. Every rank builds
the same initial field and takes its own block; rank 0 gathers the
field, checks it and writes the one row, and its verdict is broadcast
so that every rank fails together.

A mesh run takes the JAX driver's shaping axes, with its checks and
messages: ``halo_wire`` (the ghosts cross narrowed; ``--verify`` allows
the wire's rounding, one unit roundoff of it a step), ``--impl
partitioned`` with ``halo_parts`` (sub-slab transfers), ``halo_width``
(the deep-halo window; ``--verify`` rounds its steps up to a window) and
``fuse_steps`` (``run_distributed_fused``: the timed loop as chains of
fuse_steps-step dispatches, each a CUDA graph replay on the card, the
graphs kept for the rank's run and freed before its process group;
``--verify`` runs the chain, its steps rounded up to it). The rows carry
JAX's fields for them (``fuse_steps``, ``dispatches``,
``secs_per_dispatch``, ``halo_parts``, ``halo_width`` with the window's
pricing, ``wire_dtype``; ``halo_bytes_per_chip_per_iter`` at the wire's
itemsize).

Arm names are the port's own (``bench/__init__.py`` ``JAX_STENCIL_IMPLS``
maps the JAX names); a JAX name is refused with the port's name for it.
One device takes its arms from the family's module
(:func:`single_device_impls`), as the JAX driver takes ``kernels.IMPLS``.

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
from tpu_comm_torch.bench.trace import maybe_profile
from tpu_comm_torch.kernels import kernels_for, reference, stencil_name
from tpu_comm_torch.kernels.tiling import (
    check_wave_bc,
    from_numpy_field,
    numpy_dtype,
    to_numpy_field,
    torch_dtype,
)

#: default global points per dimension (the JAX driver's defaults)
DEFAULT_SIZES = {1: 1 << 20, 2: 4096, 3: 256}
#: the arms of a mesh run; ``auto`` resolves to ``overlap``
DIST_IMPLS = ("torch", "overlap", "partitioned", "block", "stream", "multi",
              "wave")
#: the unit roundoff of a narrow dtype (a field's or a halo wire's)
EPS = {"bfloat16": 2.0 ** -9, "float16": 2.0 ** -11}
#: the 3D arms that take no ``--chunk`` (the JAX driver's reason: they
#: stream one plane a step); their rows carry no chunk, as JAX's
UNCHUNKED_3D = ("wave", "multi")
#: the arms that take ``--chunk``, each with its family module's default
CHUNK_DEFAULTS = {
    "stream": "default_chunk",
    "stream2": "default_chunk",
    "grid": "default_grid_chunk",
    "wave": "default_wave_chunk",
    "multi": "default_multi_chunk",
}


@dataclass
class StencilConfig:
    dim: int = 1
    size: int = 1 << 20  # global points per dimension
    # 0 = the star of ``dim``; 9 = the 2D box, 27 = the 3D box
    points: int = 0
    iters: int = 100
    dtype: str = "float32"
    bc: str = "dirichlet"
    # "auto" resolves to "stream" on one device, "overlap" on a mesh
    impl: str = "auto"
    # the chunked arms' (CHUNK_DEFAULTS) rows per CUDA block (1D: rows of
    # 128 elements; 2D: rows of a strip or tile) or z-planes per block
    # (3D); None = the kernel's default. It sets the launch grid, never
    # the result.
    chunk: int | None = None
    # iterations fused per pass (one device) or per exchange (mesh) of
    # --impl multi; iters must be a multiple of this
    t_steps: int = 8
    # ranks per mesh axis; None = one device, no process group
    mesh: tuple[int, ...] | None = None
    # ghost pack of a 3D mesh run: "fused" (slice copies) or "kernel"
    pack: str = "fused"
    # mesh only: the ghosts cross in this narrower dtype ("bfloat16",
    # "float16") and are widened on receipt; None = the field's dtype
    halo_wire: str | None = None
    # mesh only, --impl partitioned: sub-slabs a face (None: 2)
    halo_parts: int | None = None
    # mesh only, the star's torch/overlap arms: the deep-halo window, one
    # chained width-K exchange a K exchange-free steps
    halo_width: int | None = None
    # mesh only: the timed loop as chains of fuse_steps-step dispatches,
    # each a CUDA graph replay on the card; None = one step a call
    fuse_steps: int | None = None
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
    # write a torch.profiler trace of the timed loop to DIR/rank<r>.json
    profile: str | None = None
    load: str | None = None  # start from this .npy instead of init_field
    dump: str | None = None  # write the post-run field state here

    @property
    def global_shape(self) -> tuple[int, ...]:
        return (self.size,) * self.dim


def _stencil_tag(cfg: StencilConfig) -> str:
    """Workload base name: the box stencils are their own workloads."""
    suffix = f"-{stencil_name(cfg.points)}" if cfg.points else ""
    return f"stencil{cfg.dim}d{suffix}"


def single_device_impls(kernels) -> tuple[str, ...]:
    """The arms one device runs for a family module: its ``STEPS``, and
    ``multi`` where it has temporal blocking (JAX's ``kernels.IMPLS``
    plus ``pallas-multi``)."""
    return tuple(kernels.STEPS) + (
        ("multi",) if hasattr(kernels, "run_multi") else ()
    )


def resolve_impl(impl: str, distributed: bool = False, dim: int = 1,
                 points: int = 0) -> str:
    """The arm ``impl`` names for the stencil of ``dim`` and ``points``:
    ``auto`` is ``overlap`` on a mesh and ``stream`` on one device (JAX's
    ``auto`` on one device picks by a table of tuned A/B results, which
    the port does not have yet: ROADMAP queue A item 11). A JAX arm name,
    an arm of the other mode, one the family lacks or an unknown name
    raises ValueError."""
    if impl == "auto":
        return "overlap" if distributed else "stream"
    if impl in JAX_STENCIL_IMPLS:
        raise ValueError(
            f"--impl {impl} is the JAX package's name; the port calls this "
            f"arm {JAX_STENCIL_IMPLS[impl]!r}"
        )
    if distributed:
        if impl in DIST_IMPLS:
            return impl
        if impl in CHUNK_DEFAULTS:
            raise ValueError(
                f"--impl {impl} is an arm of one device: drop --mesh (a "
                f"mesh has {', '.join(('auto',) + DIST_IMPLS)})"
            )
        raise ValueError(
            f"--impl must be one of {('auto',) + DIST_IMPLS}, got {impl!r}"
        )
    impls = single_device_impls(kernels_for(dim, points))
    # a family without temporal blocking is answered by _validate
    if impl in impls or impl == "multi":
        return impl
    family = f"--points {points}" if points else f"dim={dim}"
    if impl in CHUNK_DEFAULTS:
        raise ValueError(
            f"--impl {impl} not available for {family} (choices: "
            f"{('auto',) + impls})"
        )
    if impl in DIST_IMPLS:
        raise ValueError(
            f"--impl {impl} is an arm of a mesh run: pass --mesh (one "
            f"device has {', '.join(('auto',) + impls)})"
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
    got: np.ndarray, want: np.ndarray, dtype: str, iters: int = 0,
    halo_wire: str | None = None,
) -> None:
    """The JAX driver's verification envelope. float32: bitwise-grade
    (``1e-6`` or one f32 ulp per iteration of the field's scale). A
    sub-fp32 field and its golden round at different points, and so do
    the ghosts of a narrow ``halo_wire`` (once an exchange), so the error
    is a relative unit roundoff of that dtype accumulating at most once
    per iteration (Jacobi averaging is a contraction), still far below a
    wrong-neighbour bug."""
    scale = float(np.abs(want.astype(np.float64)).max()) or 1.0

    def envelope(rounding_dtype: str) -> float:
        return EPS.get(rounding_dtype, 1e-2) * max(iters, 1) * scale

    if dtype == "float32":
        atol = max(1e-6, 2.0 ** -23 * max(iters, 1) * scale)
    else:
        atol = max(1e-2, envelope(dtype))
    if halo_wire is not None and halo_wire != dtype:
        atol = max(atol, envelope(halo_wire))
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
        u0, cfg.tol, cfg.iters, check_every=cfg.check_every, bc=cfg.bc,
        step=reference.GOLDEN_STEPS[cfg.points],
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
    kernels_for(cfg.dim, cfg.points)  # --points needs its --dim
    if cfg.size < 3:
        raise ValueError(f"--size must be >= 3, got {cfg.size}")
    if cfg.iters < 1:
        raise ValueError(f"--iters must be >= 1, got {cfg.iters}")
    if cfg.t_steps < 1:
        raise ValueError(f"--t-steps must be >= 1, got {cfg.t_steps}")
    if cfg.chunk is not None and cfg.chunk < 1:
        raise ValueError(f"--chunk must be >= 1, got {cfg.chunk}")
    reference.check_bc(cfg.bc)
    torch_dtype(cfg.dtype)
    cfg = dataclasses.replace(cfg, impl=resolve_impl(
        cfg.impl, cfg.mesh is not None, cfg.dim, cfg.points))
    if cfg.impl == "multi":
        if cfg.mesh is None and cfg.dim == 3 and cfg.bc != "dirichlet":
            raise ValueError(
                "--impl multi in 3D (wavefront temporal blocking) supports "
                "--bc dirichlet only; use stream for periodic"
            )
        if cfg.iters % cfg.t_steps != 0:
            raise ValueError(
                f"--iters ({cfg.iters}) must be a multiple of --t-steps "
                f"({cfg.t_steps}) for --impl multi"
            )
        if cfg.tol is not None:
            raise ValueError(
                "--tol convergence mode and --impl multi are exclusive "
                "(the residual check needs per-step granularity)"
            )
    if cfg.mesh is None:
        kernels = kernels_for(cfg.dim, cfg.points)
        if cfg.impl == "multi" and not hasattr(kernels, "run_multi"):
            raise ValueError(
                f"--impl multi is not available for --points {cfg.points} "
                f"(choices: {single_device_impls(kernels)})"
            )
        if cfg.pack != "fused":
            raise ValueError("--pack applies to a 3D mesh run: pass --mesh")
        if cfg.halo_wire is not None:
            raise ValueError(
                "--halo-wire applies to the distributed path only (pass "
                "--mesh); a single device sends no halos"
            )
        if cfg.fuse_steps is not None:
            raise ValueError(
                "--fuse-steps applies to the distributed path only (pass "
                "--mesh); the single-device loop is already one program"
            )
        if cfg.halo_parts is not None:
            raise ValueError(
                "--halo-parts applies to the distributed path only (pass "
                "--mesh with --impl partitioned)"
            )
        if cfg.halo_width is not None:
            raise ValueError(
                "--halo-width applies to the distributed path only (pass "
                "--mesh); a single device exchanges no ghost zone to "
                "deepen (single-device temporal blocking is --impl multi)"
            )
        if cfg.impl == "wave":
            check_wave_bc(cfg.bc)
        if cfg.impl not in CHUNK_DEFAULTS and cfg.chunk is not None:
            raise ValueError(
                f"--chunk applies to --impl {'|'.join(CHUNK_DEFAULTS)}; "
                f"--impl {cfg.impl} chooses its own launch grid"
            )
        if (cfg.dim == 3 and cfg.impl in UNCHUNKED_3D
                and cfg.chunk is not None):
            raise ValueError(
                f"--chunk does not apply to 3D {cfg.impl}: the "
                "wavefront/wave kernels stream one plane per grid step (no "
                "chunk length; multi's window is set by t_steps)"
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


def _round_up(v: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``v`` (a ``multi`` run advances in
    strides of ``t_steps``)."""
    return v + (-v) % m


def run_single_device(cfg: StencilConfig) -> dict:
    """Single-device stencil benchmark; returns (and with ``jsonl``
    appends) the result row."""
    from tpu_comm_torch.topo import get_device

    cfg = _validate(cfg)
    device = get_device(cfg.backend)
    kernels = kernels_for(cfg.dim, cfg.points)
    dtype = torch_dtype(cfg.dtype)
    u_dev = from_numpy_field(
        _initial_field(cfg, numpy_dtype(dtype)), device, dtype
    )
    # the golden starts from the field as the device holds it (a bf16
    # field is rounded on its way there)
    u0 = to_numpy_field(u_dev)
    multi = cfg.impl == "multi"
    key = "planes_per_chunk" if cfg.dim == 3 else "rows_per_chunk"
    if cfg.impl in CHUNK_DEFAULTS and not (
            cfg.dim == 3 and cfg.impl in UNCHUNKED_3D):
        if cfg.chunk is None:
            default = getattr(kernels, CHUNK_DEFAULTS[cfg.impl])
            chunk, chunk_source = default(cfg.global_shape), "auto"
        else:
            chunk, chunk_source = cfg.chunk, "user"
        kwargs = {key: chunk}
        chunk_fields = {"chunk": chunk, "chunk_source": chunk_source}
    else:
        # the block kernels, the torch arm and the 3D wave and multi take
        # no chunk, and their rows carry none
        kwargs, chunk_fields = {}, {}
    traffic = stencil_bytes_per_iter(cfg.global_shape, u_dev.element_size())
    base = {
        "backend": cfg.backend,
        "platform": device.type,
        "mesh": [1],
        "impl": cfg.impl,
        **chunk_fields,
        **({"t_steps": cfg.t_steps} if multi else {}),
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

        with maybe_profile(cfg.profile, device):
            u_fin, iters_run, res = run_conv()
            t = time_fn(lambda: run_conv()[0],
                        warmup=max(cfg.warmup - 1, 0), reps=cfg.reps)
        record = {
            "workload": f"{_stencil_tag(cfg)}-conv",
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

    if multi:
        def run_iters(k: int):
            return kernels.run_multi(u_dev, k, bc=cfg.bc,
                                     t_steps=cfg.t_steps, **kwargs)
    else:
        def run_iters(k: int):
            return kernels.run(u_dev, k, bc=cfg.bc, impl=cfg.impl, **kwargs)

    if cfg.verify:
        v_iters = (_round_up(cfg.verify_iters, cfg.t_steps) if multi
                   else cfg.verify_iters)
        got = to_numpy_field(run_iters(v_iters))
        check_against_golden(
            got, reference.GOLDEN_RUNS[cfg.points](u0, v_iters, bc=cfg.bc),
            cfg.dtype, iters=v_iters,
        )
    with maybe_profile(cfg.profile, device):
        per_iter, t_lo, _ = time_loop_per_iter(
            run_iters, cfg.iters, warmup=cfg.warmup, reps=cfg.reps
        )
    if cfg.dump:
        np.save(cfg.dump, to_numpy_field(run_iters(cfg.iters)))
    record = {
        "workload": _stencil_tag(cfg),
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
    from tpu_comm_torch.kernels.distributed import (
        DEEP_HALO_IMPLS,
        _step_and_trips,
    )
    from tpu_comm_torch.topo import make_cart_mesh

    if cfg.chunk is not None:
        raise ValueError(
            "--chunk is a single-device tuning knob; the distributed "
            "kernels choose their own chunking"
        )
    if cfg.halo_wire is not None:
        if (torch_dtype(cfg.halo_wire).itemsize
                >= torch_dtype(cfg.dtype).itemsize):
            raise ValueError(
                f"--halo-wire {cfg.halo_wire} is not narrower than the "
                f"field dtype {cfg.dtype}; drop the flag"
            )
        if cfg.tol is not None:
            raise ValueError(
                "--halo-wire with --tol is unsupported: convergence "
                "verification asserts an exact iteration-count match "
                "with the serial golden, which reduced-precision halos "
                "can legitimately shift by a residual-check round"
            )
    cfg = _validate(cfg)
    if cfg.halo_parts is not None:
        if cfg.impl != "partitioned":
            raise ValueError(
                "--halo-parts applies to --impl partitioned (the "
                "sub-slab partitioned-communication exchange), not "
                f"--impl {cfg.impl}"
            )
        if cfg.halo_parts < 1:
            raise ValueError(
                f"--halo-parts must be >= 1, got {cfg.halo_parts}"
            )
    if cfg.fuse_steps is not None:
        if cfg.fuse_steps < 1:
            raise ValueError(
                f"--fuse-steps must be >= 1, got {cfg.fuse_steps}"
            )
        if cfg.tol is not None:
            raise ValueError(
                "--fuse-steps with --tol is unsupported: the "
                "convergence loop owns its own on-device stepping"
            )
        if cfg.impl == "multi":
            raise ValueError(
                "--fuse-steps does not apply to --impl multi (t_steps "
                "already amortizes the exchange there)"
            )
        if cfg.iters % cfg.fuse_steps != 0:
            raise ValueError(
                f"--iters ({cfg.iters}) must be a multiple of "
                f"--fuse-steps ({cfg.fuse_steps})"
            )
    if cfg.halo_width is not None:
        if cfg.halo_width < 1:
            raise ValueError(
                f"--halo-width must be >= 1, got {cfg.halo_width}"
            )
        if cfg.impl not in DEEP_HALO_IMPLS:
            raise ValueError(
                f"--halo-width applies to --impl "
                f"{'|'.join(DEEP_HALO_IMPLS)} (the chained deep-halo "
                f"window; partitioned and kernel arms keep their per-step "
                f"exchange, --impl multi shapes its window with "
                f"--t-steps), not --impl {cfg.impl}"
            )
        if cfg.points != 0:
            raise ValueError(
                f"--halo-width does not apply to --points {cfg.points} "
                "(the box stencils keep the per-step transitive "
                "exchange; the deep window is the star family's)"
            )
        if cfg.pack != "fused":
            raise ValueError(
                "--pack does not apply with --halo-width (the deep "
                "window's chained pad_halo exchange IS the pack)"
            )
        if cfg.tol is not None:
            raise ValueError(
                "--halo-width with --tol is unsupported: the residual "
                "check needs per-step granularity and the deep window "
                "advances halo_width steps per exchange"
            )
        if cfg.iters % cfg.halo_width != 0:
            raise ValueError(
                f"--iters ({cfg.iters}) must be a multiple of "
                f"--halo-width ({cfg.halo_width})"
            )
        if cfg.fuse_steps is not None and (
            cfg.halo_width > cfg.fuse_steps
            or cfg.fuse_steps % cfg.halo_width != 0
        ):
            raise ValueError(
                f"--halo-width ({cfg.halo_width}) does not tile the "
                f"--fuse-steps ({cfg.fuse_steps}) dispatch into whole "
                f"exchange-free windows; pick halo-width <= fuse-steps "
                f"with fuse-steps % halo-width == 0"
            )
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
    # arm x pack x stencil x wire x parts x width
    _step_and_trips(cart, cfg.bc, cfg.impl, _dist_kwargs(cfg),
                    cfg.halo_width or 1)
    return dataclasses.replace(cfg, mesh=mesh)


def _dist_kwargs(cfg: StencilConfig) -> dict:
    """The distributed step's options of a mesh run (those at their
    default left out)."""
    kwargs = {}
    if cfg.pack != "fused":
        kwargs["pack"] = cfg.pack
    if cfg.points:
        kwargs["stencil"] = stencil_name(cfg.points)
    if cfg.impl == "multi":
        kwargs["t_steps"] = cfg.t_steps
    for name in ("halo_wire", "halo_parts", "halo_width"):
        if getattr(cfg, name) is not None:
            kwargs[name] = getattr(cfg, name)
    return kwargs


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
    from tpu_comm_torch.comm import launch, patterns
    from tpu_comm_torch.comm.halo import halo_bytes_per_iter
    from tpu_comm_torch.domain import Decomposition
    from tpu_comm_torch.kernels.distributed import (
        release_graphs,
        run_distributed,
        run_distributed_fused,
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
    kwargs = _dist_kwargs(cfg)
    multi = cfg.impl == "multi"
    traffic = stencil_bytes_per_iter(dec.local_shape, u_dev.element_size())
    # what crosses the wire: the wire dtype's bytes. The width-1 model
    # for every arm, multi too (as the JAX driver's rows): a width-t
    # exchange every t steps sends the same bytes per iteration in t-fold
    # fewer messages; a deep-halo row rates against the chained window
    # it sends (later axes' slabs carry the earlier axes' ghosts)
    wire_itemsize = (torch_dtype(cfg.halo_wire).itemsize if cfg.halo_wire
                     else u_dev.element_size())
    deep = None
    if cfg.halo_width is not None:
        deep = patterns.deep_halo_model(
            tuple(dec.local_shape), tuple(cart.shape), wire_itemsize,
            cfg.halo_width,
        )
        halo_traffic = deep["halo_bytes_per_chip_per_iter"]
    else:
        halo_traffic = halo_bytes_per_iter(dec.local_shape, cart,
                                           wire_itemsize)
    base = {
        "backend": cfg.backend,
        "platform": device.type,
        "mesh": list(cart.shape),
        "topo_plan": cart.plan_id,
        "impl": cfg.impl,
        **({"t_steps": cfg.t_steps} if multi else {}),
        **(
            {
                "fuse_steps": cfg.fuse_steps,
                # dispatches a timed run at --iters (the seed copy is no
                # step dispatch)
                "dispatches": cfg.iters // cfg.fuse_steps,
            }
            if cfg.fuse_steps is not None else {}
        ),
        **({"halo_parts": cfg.halo_parts}
           if cfg.halo_parts is not None else {}),
        **(
            {
                "halo_width": cfg.halo_width,
                "window_wire_bytes_per_chip":
                    deep["window_wire_bytes_per_chip"],
                "msgs_per_chip_per_iter": deep["msgs_per_chip_per_iter"],
                "redundant_compute_frac": round(
                    deep["redundant_compute_frac"], 6
                ),
            }
            if deep is not None else {}
        ),
        **({"wire_dtype": cfg.halo_wire} if cfg.halo_wire else {}),
        "pack": cfg.pack,
        "bc": cfg.bc,
        "dtype": cfg.dtype,
        "size": list(cfg.global_shape),
        "local_size": list(dec.local_shape),
    }

    def barrier():
        launch.barrier(device)

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

    # the graphs a card run captures (the runs' chains, the convergence
    # round), kept for the rank's run and freed before its process group
    graphs = {}
    try:
        if cfg.tol is not None:
            def run_conv():
                return run_distributed_to_convergence(
                    u_dev, dec, cfg.tol, cfg.iters,
                    check_every=cfg.check_every, bc=cfg.bc, impl=cfg.impl,
                    graphs=graphs, **kwargs,
                )

            with maybe_profile(cfg.profile, device):
                u_fin, iters_run, res = run_conv()
                t = time_fn(lambda: run_conv()[0],
                            warmup=max(cfg.warmup - 1, 0), reps=cfg.reps,
                            barrier=barrier)
            record = {
                "workload": f"{_stencil_tag(cfg)}-dist-conv",
                **base,
                **_dispatch_fields(device, [cfg.check_every]),
                **_convergence_fields(cfg, iters_run, res, t, traffic,
                                      halo_traffic),
            }
            if cfg.verify:
                got = dec.gather(u_fin)
                _collective_verdict(
                    lambda: _verify_convergence(cfg, got, iters_run, u0),
                    device,
                )
            return finish(record, u_fin)

        if cfg.fuse_steps is not None:
            def run_iters(k: int):
                u, _ = run_distributed_fused(
                    u_dev, dec, k, cfg.fuse_steps, bc=cfg.bc,
                    impl=cfg.impl, graphs=graphs, **kwargs,
                )
                return u
        else:
            def run_iters(k: int):
                return run_distributed(
                    u_dev, dec, k, bc=cfg.bc, impl=cfg.impl, graphs=graphs,
                    **kwargs
                )

        if cfg.verify:
            v_iters = (_round_up(cfg.verify_iters, cfg.t_steps) if multi
                       else cfg.verify_iters)
            if cfg.halo_width is not None and cfg.fuse_steps is None:
                # an unfused deep-halo run advances in halo_width windows
                v_iters = _round_up(v_iters, cfg.halo_width)
            if cfg.fuse_steps is not None:
                # verify the chain the timed loop dispatches (a fuse_steps
                # multiple is a halo_width multiple too)
                v_iters = _round_up(v_iters, cfg.fuse_steps)
            got = dec.gather(sync(run_iters(v_iters)))
            _collective_verdict(
                lambda: check_against_golden(
                    got, reference.GOLDEN_RUNS[cfg.points](u0, v_iters,
                                                           bc=cfg.bc),
                    cfg.dtype, iters=v_iters, halo_wire=cfg.halo_wire,
                ),
                device,
            )
        with maybe_profile(cfg.profile, device):
            per_iter, t_lo, _ = time_loop_per_iter(
                run_iters, cfg.iters, warmup=cfg.warmup, reps=cfg.reps,
                barrier=barrier,
            )
        field = run_iters(cfg.iters) if cfg.dump else None
    finally:
        release_graphs(graphs)
    record = {
        "workload": f"{_stencil_tag(cfg)}-dist",
        **base,
        **_dispatch_fields(device, graph_steps(cfg)),
        **({"secs_per_dispatch": per_iter * cfg.fuse_steps}
           if cfg.fuse_steps is not None else {}),
        **_slope_fields(cfg, per_iter, t_lo, traffic, halo_traffic),
    }
    return finish(record, field)


def graph_steps(cfg: StencilConfig) -> list[int]:
    """The steps one graph replay of a card mesh run advances: a fused
    row's dispatch, else each loop of the slope (``iters`` and ``3 *
    iters``) cut by ``graphs.graph_chunk`` in trips (a ``multi`` trip is
    ``t_steps`` steps, a deep-halo one a window)."""
    from tpu_comm_torch.kernels.graphs import graph_chunk

    if cfg.fuse_steps is not None:
        return [cfg.fuse_steps]
    per_trip = cfg.t_steps if cfg.impl == "multi" else (cfg.halo_width or 1)
    return [graph_chunk(k // per_trip) * per_trip
            for k in (cfg.iters, 3 * cfg.iters)]


def _dispatch_fields(device, steps: list) -> dict:
    """How a mesh row's loops ran: on the card, replays of CUDA graphs of
    ``steps`` steps each (the slope's two loops, a fused row's dispatch,
    a ``--tol`` row's round); on the CPU, eager steps."""
    if device.type != "cuda":
        return {"dispatch": "eager"}
    return {"dispatch": "graph", "graph_steps": steps}


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
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.topo import get_device

    cfg = _validate_distributed(cfg)
    device = get_device(cfg.backend)
    return launch.run_world(
        run_rank, math.prod(cfg.mesh), device, (cfg,),
        timeout_s=cfg.dist_timeout, what=f"--mesh {cfg.mesh}",
    )
