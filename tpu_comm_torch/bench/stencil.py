"""Single-device Jacobi stencil driver (port of the single-device half of
``tpu_comm/bench/stencil.py``).

Parse a config, initialise the field (or ``--load`` it), optionally
check the kernels against the serial NumPy golden, time the relaxation
loop by slope, and report one JSON row with GB/s and iterations/s. The
loop is a Python loop of one kernel launch per step (``kernels.run``),
or with ``--tol`` the convergence loop.

Rows keep the JAX driver's identity fields (``workload``, ``impl``,
``backend``, ``platform``, ``dtype``, ``bc``, ``size``, ``iters``, ...),
so one reader serves both packages' rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from tpu_comm_torch.bench.timing import (
    emit_jsonl,
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
#: the arms the port has; ``auto`` resolves to ``stream``
IMPLS = ("stream",)
#: the JAX driver's other arms, refused until a later slice ports them
UNPORTED_IMPLS = (
    "lax", "pallas", "pallas-grid", "pallas-stream", "pallas-stream2",
    "pallas-wave", "pallas-multi", "overlap", "partitioned", "multi",
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


def resolve_impl(impl: str) -> str:
    """``auto`` -> ``stream``; a JAX arm not yet ported or an unknown
    name raises ValueError."""
    if impl == "auto":
        return "stream"
    if impl in IMPLS:
        return impl
    if impl in UNPORTED_IMPLS:
        raise ValueError(
            f"--impl {impl} is not yet ported; see ROADMAP.md (ported: "
            f"{', '.join(('auto',) + IMPLS)})"
        )
    raise ValueError(
        f"--impl must be one of {('auto',) + IMPLS}, got {impl!r}"
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
    return dataclasses.replace(cfg, impl=resolve_impl(cfg.impl))


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
    if cfg.chunk is None:
        chunk, chunk_source = kernels.default_chunk(cfg.global_shape), "auto"
    else:
        chunk, chunk_source = cfg.chunk, "user"
    kwargs = {key: chunk}
    traffic = stencil_bytes_per_iter(cfg.global_shape, u_dev.element_size())
    base = {
        "backend": cfg.backend,
        "platform": device.type,
        "mesh": [1],
        "impl": cfg.impl,
        "chunk": chunk,
        "chunk_source": chunk_source,
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
        secs = t.median
        per_iter = secs / iters_run if iters_run else None
        record = {
            "workload": f"stencil{cfg.dim}d-conv",
            **base,
            "tol": cfg.tol,
            "check_every": cfg.check_every,
            "max_iters": cfg.iters,
            "iters": iters_run,
            "residual": res,
            "converged": res <= cfg.tol,
            "secs": secs,
            "secs_per_iter": per_iter,
            "iters_per_s": (iters_run / secs) if secs > 0 else None,
            "gbps_eff": (
                traffic / per_iter / 1e9 if per_iter and per_iter > 0
                else None
            ),
            "verified": bool(cfg.verify),
            **t.phase_fields(),
            **{f"t_{k}": v for k, v in t.summary().items()},
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
    # a loop shorter than the clock's noise has no measurable slope:
    # report nulls rather than invent a rate
    resolved = per_iter > 1e-9
    record = {
        "workload": f"stencil{cfg.dim}d",
        **base,
        "iters": cfg.iters,
        "secs": per_iter * cfg.iters,
        "secs_per_iter": per_iter,
        "iters_per_s": (1.0 / per_iter) if resolved else None,
        "gbps_eff": (traffic / per_iter / 1e9) if resolved else None,
        "below_timing_resolution": not resolved,
        "verified": bool(cfg.verify),
        **t_lo.phase_fields(),
        **{f"t_{k}": v for k, v in t_lo.summary().items()},
    }
    if cfg.jsonl:
        emit_jsonl(record, cfg.jsonl)
    return record
