"""STREAM-style device-memory bandwidth driver (port of
``tpu_comm/bench/membw.py`` ``run_membw``).

The copy side of the reference's "stencil/copy kernels": the STREAM
quartet ``copy``, ``scale`` (``x·s``), ``add`` (``x + b``) and ``triad``
(``b + x·s``) chained ``iters`` times over a flat array, timed by slope,
one JSON row with GB/s. Its measured copy is the honest denominator for
the stencil kernels' rates (the data sheet's bandwidth is reached by no
kernel).

Arms (``tpu_comm_torch.bench`` maps the JAX names): ``torch`` (one
PyTorch op per pass), ``chunked`` (the hand-written CUDA kernels of the
Pallas bodies), and the copy-only ``stream`` (the 1D stencil kernel with
its arithmetic removed) and ``dma`` (a copy pipelined by hand through
``depth`` shared-memory slots). In the timed loop the scalar is 1 and the
second operand and the copy's addend are 0, so every op is the identity
and any number of chained passes returns the input bit for bit.

Traffic (STREAM convention, bytes per iteration): copy and scale move
``2·N·itemsize``, add and triad ``3·N·itemsize``.

Rows keep the JAX driver's identity fields, so one reader serves both
packages' rows. Not ported (ROADMAP): the tuned-chunk tables (TPU
measurements; ``chunk_source`` is ``auto`` or ``user``), ``--dimsem``, the
obs span and byte counter, the partial-row salvage and the
``pipeline-gap`` sweep.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tpu_comm_torch.bench import (
    JAX_MEMBW_IMPLS,
    MEMBW_IMPLS,
    MEMBW_OPS,
    TRAFFIC,
)
from tpu_comm_torch.bench.timing import emit_jsonl, time_loop_per_iter
from tpu_comm_torch.kernels import membw as kernels
from tpu_comm_torch.kernels.tiling import (
    DEFAULT_DMA_DEPTH,
    from_numpy_field,
    knob_tag,
    numpy_dtype,
    to_numpy_field,
    torch_dtype,
)

LANES = kernels.LANES


@dataclass
class MembwConfig:
    op: str = "triad"
    impl: str = "chunked"
    backend: str = "cuda"
    size: int = 1 << 26            # elements (256 MiB per float32 array)
    dtype: str = "float32"
    chunk: int | None = None       # rows of 128 per chunk, kernel arms only
    aliased: bool = False          # write each pass into its input
    depth: int | None = None       # ring slots of the dma arm (None: 2)
    iters: int = 50
    warmup: int = 2
    reps: int = 5
    verify: bool = True
    jsonl: str | None = None


def check_impl(impl: str) -> None:
    """ValueError for an arm the port does not have; a JAX arm name is
    answered with the port's own name for it."""
    if impl in MEMBW_IMPLS:
        return
    if impl in JAX_MEMBW_IMPLS:
        raise ValueError(
            f"--impl {impl} is the JAX package's name; the port calls this "
            f"arm {JAX_MEMBW_IMPLS[impl]!r}"
        )
    raise ValueError(f"--impl must be one of {MEMBW_IMPLS}, got {impl!r}")


def _validate(cfg: MembwConfig) -> None:
    """The JAX driver's argument rules, checked before the device lookup."""
    if cfg.op not in MEMBW_OPS:
        raise ValueError(f"op must be one of {MEMBW_OPS}, got {cfg.op!r}")
    check_impl(cfg.impl)
    torch_dtype(cfg.dtype)
    if cfg.iters < 1:
        raise ValueError(f"--iters must be >= 1, got {cfg.iters}")
    if cfg.impl in ("stream", "dma") and cfg.op != "copy":
        raise ValueError(
            f"--impl {cfg.impl} is a copy arm ("
            + ("the 1D stencil kernel with the arithmetic removed"
               if cfg.impl == "stream"
               else "the copy pipelined by hand through shared memory")
            + "); it exists for --op copy only"
        )
    if cfg.impl == "dma":
        if cfg.aliased:
            raise ValueError(
                "--aliased does not apply to the dma arm, which owns its "
                "own schedule; its knobs are --chunk and --depth"
            )
        if cfg.depth is not None and not (
            2 <= cfg.depth <= kernels.DMA_MAX_DEPTH
        ):
            raise ValueError(
                f"--depth must be in [2, {kernels.DMA_MAX_DEPTH}], got "
                f"{cfg.depth}: one slot cannot overlap its own load and "
                "store"
            )
    elif cfg.depth is not None:
        raise ValueError("--depth (ring slots) applies to --impl dma only")
    if cfg.impl == "torch":
        if cfg.chunk is not None:
            raise ValueError("--chunk applies to the kernel arms only")
        if cfg.aliased:
            raise ValueError("--aliased applies to the kernel arms only")
        if cfg.size < 1:
            raise ValueError(f"--size must be >= 1, got {cfg.size}")
    else:
        if cfg.size < LANES or cfg.size % LANES:
            raise ValueError(
                f"--impl {cfg.impl} needs --size to be a positive multiple "
                f"of {LANES} (rows of {LANES} elements), got {cfg.size}"
            )
        if cfg.chunk is not None and cfg.chunk < 1:
            raise ValueError(f"--chunk must be >= 1, got {cfg.chunk}")


def _oracle(op: str, impl: str, x: np.ndarray, b: np.ndarray, s: float,
            z: float) -> np.ndarray:
    """NumPy golden for one iteration with the given operand values."""
    x64 = x.astype(np.float64)
    if op == "copy":
        # the torch arm's copy adds the runtime zero
        return x64 + z if impl == "torch" else x64
    if op == "scale":
        return x64 * s
    if op == "add":
        return x64 + b.astype(np.float64)
    return b.astype(np.float64) + x64 * s


def _verify(cfg: MembwConfig, rows_per_chunk: int, device: torch.device,
            depth: int) -> None:
    """One iteration with non-trivial operand values against the golden;
    the dma arm bitwise. At most 8 chunks, as in the JAX package, except
    for the dma arm on a card: enough for every CTA's ring to wrap
    (``kernels.dma_verify_size``)."""
    rng = np.random.default_rng(0)
    dtype = torch_dtype(cfg.dtype)
    n = min(cfg.size, 8 * LANES * max(rows_per_chunk, 8))
    if cfg.impl == "dma" and device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        n = kernels.dma_verify_size(
            cfg.size, dtype.itemsize, rows_per_chunk, depth,
            props.multi_processor_count,
            props.shared_memory_per_multiprocessor,
            props.shared_memory_per_block_optin)
    host = numpy_dtype(dtype)
    x = from_numpy_field(rng.standard_normal(n).astype(host), device, dtype)
    b = from_numpy_field(rng.standard_normal(n).astype(host), device, dtype)
    s, z = 0.5, 0.25  # exactly representable in bf16/fp16
    got = kernels.chained(x, b, s, z, cfg.op, cfg.impl, 1, rows_per_chunk,
                          cfg.aliased, depth)
    if cfg.impl == "dma":
        # the arm moves bytes and computes nothing: any tolerance would
        # hide a slot-reuse race
        bad = int((got.view(torch.uint8) != x.view(torch.uint8)).sum())
        if bad:
            raise AssertionError(
                f"membw copy/dma bitwise verification failed: {bad} "
                "byte(s) differ from the source buffer"
            )
        return
    want = _oracle(cfg.op, cfg.impl, to_numpy_field(x), to_numpy_field(b),
                   s, z)
    got64 = to_numpy_field(got).astype(np.float64)
    tol = 1e-6 if x.element_size() >= 4 else 5e-2
    if not np.allclose(got64, want, atol=tol, rtol=tol):
        raise AssertionError(
            f"membw {cfg.op}/{cfg.impl} verification failed: max err "
            f"{np.abs(got64 - want).max()}"
        )


def run_membw(cfg: MembwConfig) -> dict:
    """Run one (op, impl) bandwidth measurement; returns (and with
    ``jsonl`` appends) the record."""
    from tpu_comm_torch.topo import get_device

    _validate(cfg)
    device = get_device(cfg.backend)
    dtype = torch_dtype(cfg.dtype)
    n = cfg.size
    depth = (cfg.depth or DEFAULT_DMA_DEPTH) if cfg.impl == "dma" else None
    if cfg.impl == "torch":
        rows_per_chunk, chunk_source = 0, None
    elif cfg.chunk is not None:
        rows_per_chunk, chunk_source = cfg.chunk, "user"
    else:
        rows_per_chunk = kernels.default_chunk(cfg.impl, dtype, cfg.op)
        chunk_source = "auto"
    if cfg.verify:
        _verify(cfg, rows_per_chunk, device, depth or DEFAULT_DMA_DEPTH)

    rng = np.random.default_rng(1)
    x = from_numpy_field(
        rng.standard_normal(n).astype(numpy_dtype(dtype)), device, dtype
    )
    # unit scalar and zero operands: every op is the identity, so chained
    # passes stay value-stable at any iteration count
    b = torch.zeros(n, dtype=dtype, device=device)

    def run_iters(k: int):
        return kernels.chained(
            x, b, 1.0, 0.0, cfg.op, cfg.impl, k, rows_per_chunk or None,
            cfg.aliased, depth or DEFAULT_DMA_DEPTH,
        )

    per_iter, t_lo, _ = time_loop_per_iter(
        run_iters, cfg.iters, warmup=cfg.warmup, reps=cfg.reps
    )
    # a loop shorter than the clock's noise has no measurable slope
    resolved = per_iter > 1e-9
    bytes_per_iter = TRAFFIC[cfg.op] * n * x.element_size()
    knobs = knob_tag(cfg.aliased, depth)
    record = {
        "workload": f"membw-{cfg.op}",
        "impl": cfg.impl,
        "backend": cfg.backend,
        "platform": device.type,
        "mesh": [1],
        "dtype": cfg.dtype,
        "size": [n],
        "iters": cfg.iters,
        "chunk": rows_per_chunk or None,
        **({"chunk_source": chunk_source} if chunk_source else {}),
        **({"knobs": knobs} if knobs else {}),
        "secs_per_iter": per_iter,
        "gbps_eff": bytes_per_iter / per_iter / 1e9 if resolved else None,
        "below_timing_resolution": not resolved,
        "verified": bool(cfg.verify),
        **t_lo.phase_fields(),
        **{f"t_{k}": v for k, v in t_lo.summary().items()},
    }
    if cfg.jsonl:
        emit_jsonl(record, cfg.jsonl)
    return record


def config_for_arm(cfg: MembwConfig, impl: str) -> MembwConfig:
    """``cfg`` for one arm of ``--impl both``: the torch arm drops the
    kernel-only knobs (``chunk``, ``aliased``)."""
    if impl == "torch":
        return dataclasses.replace(cfg, impl=impl, chunk=None, aliased=False)
    return dataclasses.replace(cfg, impl=impl)
