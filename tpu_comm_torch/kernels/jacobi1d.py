"""1D 3-point Jacobi step: plain PyTorch versions + hand-written CUDA
kernels.

Port of every arm of ``tpu_comm/kernels/jacobi1d.py``'s ``STEPS`` and of
its ``pallas-multi``: ``lax`` (``step_lax``), ``pallas-stream``
(``step_pallas_stream`` and its kernel ``_jacobi1d_stream_kernel``),
``pallas-stream2`` (the same kernel with ``colfix=True``), ``pallas``
(``step_pallas``, ``_jacobi1d_kernel``), ``pallas-grid``
(``step_pallas_grid``, ``_jacobi1d_grid_kernel`` and its endpoint fix
``_fix_global_endpoints``), ``pallas-wave`` (``step_pallas_wave``,
``_jacobi1d_wave_kernel``), ``pallas-multi`` (``step_pallas_multi``,
its kernel ``_jacobi1d_multi_kernel`` and its edge fix
``_edge_cone_fix_multi``) and the mesh ``pallas-wave``'s local update
(``step_pallas_wave_ghost``, ``_jacobi1d_wave_ghost_kernel``).

Update rule (Jacobi, ping-pong):  u'[i] = (u[i-1] + u[i+1]) / 2
Boundary: ``dirichlet`` freezes u[0] and u[N-1]; ``periodic`` wraps.

- ``step_plain``  — ``torch.roll`` expression in float32, narrowed once.
  It repeats the TPU stream kernel's arithmetic (not JAX's ``step_lax``,
  which adds in the field dtype), and is what the CPU runs.
- ``step_torch``  — JAX's ``step_lax``: plain PyTorch in the field's
  dtype (``kernels/padded.py``), no kernel; the ``torch`` arm.
- ``step_stream`` — the wrapper of ``jacobi1d_kernel`` in
  ``csrc/jacobi_stream.cu``: a CUDA tensor goes to the kernel, a CPU
  tensor to ``step_plain``.
- ``step_stream2`` — the same kernel in its column-strip carry form
  (each cell loaded once, its neighbours by warp shuffles): bitwise
  ``step_stream``'s result.
- ``step_grid``   — the wrapper of ``jacobi1d_grid_kernel`` in
  ``csrc/grid.cu``: one window a CTA, copied in whole, then computed.
- ``step_wave``   — the wrapper of ``jacobi1d_wave_kernel`` in
  ``csrc/wave.cu``: each CTA streams its range of blocks through a ring
  in shared memory. Dirichlet only, on every device, as JAX's arm.
- ``step_wave_ghost_plain`` — one step of a rank's block whose two end
  cells read the exchanged ghost cells, f32 compute, one narrowing, no
  freeze (the caller applies the bc).
- ``step_wave_ghost`` — the wrapper of ``jacobi1d_wave_kernel``'s
  ghost-fed form in ``csrc/wave.cu``: the mesh ``wave`` arm's update.
- ``step_block``  — the wrapper of ``jacobi1d_block_kernel`` in
  ``csrc/jacobi_block.cu``, the port of the TPU's whole-field kernel:
  the same function by another design (see the source). It is the
  distributed step's ``block`` local update and a single-device arm.
- ``step_multi_plain`` — ``t_steps`` steps of ``step_plain``'s f32
  arithmetic, the dirichlet ends kept every step, narrowed once.
- ``step_multi``  — the wrapper of ``jacobi1d_multi_kernel`` in
  ``csrc/multi.cu`` (temporal blocking: ``t_steps`` steps in one pass);
  the single-device ``multi`` arm, through :func:`run_multi`.
"""

from __future__ import annotations

import torch

from tpu_comm_torch.kernels import (
    multi_plain,
    run_steps,
    run_steps_multi,
    run_steps_to_convergence,
)
from tpu_comm_torch.kernels import padded
from tpu_comm_torch.kernels.reference import check_bc
from tpu_comm_torch.kernels.tiling import (
    KERNEL_DTYPE_CODES,
    check_ghosts,
    check_kernel_args,
    check_staged_smem,
    check_wave_bc,
    f32_compute,
    grid_smem,
    launch_kernel,
    launch_multi,
    launch_stencil,
    narrow_store,
    staged_default_rows,
    wave_smem,
)

#: default rows of 128 elements each CUDA block covers (the counterpart
#: of the TPU arm's rows_per_chunk); it sets the grid size, never the
#: result. Small chunks mean many blocks, which keeps more loads in flight
STREAM_DEFAULT_ROWS = 8


#: output elements a CUDA block of the multi kernel owns, in rows of 128
#: (4096 elements) when the caller passes none; it sets the grid, never
#: the result
MULTI_DEFAULT_ROWS = 32


def default_chunk(shape: tuple) -> int:
    """The chunk ``step_stream`` uses when the caller passes none."""
    del shape
    return STREAM_DEFAULT_ROWS


def default_multi_chunk(shape: tuple) -> int:
    """The chunk ``step_multi`` uses when the caller passes none."""
    del shape
    return MULTI_DEFAULT_ROWS


def default_grid_chunk(shape: tuple) -> int:
    """The rows of 128 cells a ``step_grid`` window holds when the caller
    passes none: sized to shared memory (``tiling.STAGED_SMEM_TARGET``)."""
    del shape
    return staged_default_rows(grid_smem, 1)


def default_wave_chunk(shape: tuple) -> int:
    """The rows of 128 cells a ``step_wave`` ring block holds when the
    caller passes none: sized to shared memory."""
    del shape
    return staged_default_rows(wave_smem, 1)


def _step_f32(a: torch.Tensor, bc: str) -> torch.Tensor:
    """One step of a float32 field, unrounded."""
    new = (torch.roll(a, 1) + torch.roll(a, -1)) * 0.5
    if bc == "dirichlet":
        new[0], new[-1] = a[0], a[-1]
    return new


def step_plain(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 1D step in plain PyTorch: f32 compute, one RTNE narrowing."""
    check_bc(bc)
    return narrow_store(_step_f32(f32_compute(u), bc), u.dtype, out)


def step_multi_plain(u: torch.Tensor, bc: str = "dirichlet",
                     t_steps: int = 8,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """``t_steps`` 1D steps in plain PyTorch: f32 compute, one RTNE
    narrowing at the end."""
    return multi_plain(_step_f32, u, bc, t_steps, out)


def step_wave_ghost_plain(u: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """One step of a rank's 1D block in plain PyTorch, its two end cells'
    outer neighbours the ghost cells ``lo`` and ``hi`` (shape (1,)):
    f32 compute, one RTNE narrowing, nothing frozen."""
    lo, hi = check_ghosts(u, (lo, hi), ((1,), (1,)), "cells", out)
    p = torch.cat([f32_compute(lo), f32_compute(u), f32_compute(hi)])
    return narrow_store((p[:-2] + p[2:]) * 0.5, u.dtype, out)


def step_wave_ghost(u: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    rows_per_chunk: int | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """One step of a rank's 1D block fed by its ghost cells ``lo`` and
    ``hi`` (shape (1,), the block's dtype and device): the ghost-fed wave
    kernel for a CUDA tensor, :func:`step_wave_ghost_plain` for a CPU
    tensor. Nothing is frozen: the caller applies the bc. A ring block is
    ``rows_per_chunk`` rows of 128 cells (default
    :func:`default_wave_chunk`). Writes into ``out`` (which must not
    alias ``u``) when given. ``step_wave_ghost.launches`` counts kernel
    launches."""
    lo, hi = check_ghosts(u, (lo, hi), ((1,), (1,)), "cells", out)
    if u.device.type == "cpu":
        return step_wave_ghost_plain(u, lo, hi, out)
    out = check_kernel_args(u, 1, out, min_extents=(1,))
    if rows_per_chunk is None:
        rows_per_chunk = default_wave_chunk(u.shape)
    if rows_per_chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {rows_per_chunk}")
    check_staged_smem("wave", wave_smem(1, rows_per_chunk, u.element_size()),
                      rows_per_chunk)
    launch_kernel("tc_jacobi1d_wave_ghost", u, u.data_ptr(), out.data_ptr(),
                  lo.data_ptr(), hi.data_ptr(), u.numel(),
                  KERNEL_DTYPE_CODES[u.dtype], rows_per_chunk)
    step_wave_ghost.launches += 1
    return out


step_wave_ghost.launches = 0


def step_stream(u: torch.Tensor, bc: str = "dirichlet",
                rows_per_chunk: int | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """One 1D step: the CUDA kernel for a CUDA tensor, ``step_plain`` for
    a CPU tensor. Writes into ``out`` (which must not alias ``u``) when
    given. ``step_stream.launches`` counts kernel launches."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 1, out)
    if rows_per_chunk is None:
        rows_per_chunk = default_chunk(u.shape)
    launch_stencil("tc_jacobi1d_stream", u, out, bc, rows_per_chunk)
    step_stream.launches += 1
    return out


step_stream.launches = 0


def step_torch(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 1D step in plain PyTorch in the field's dtype (JAX's
    ``step_lax``), on any device; no kernel."""
    return padded.step_torch(u, bc, "star", out)


def step_stream2(u: torch.Tensor, bc: str = "dirichlet",
                 rows_per_chunk: int | None = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """One 1D step by the stream kernel's column-strip carry form: the
    CUDA kernel for a CUDA tensor, ``step_plain`` for a CPU tensor.
    Writes into ``out`` (which must not alias ``u``) when given.
    ``step_stream2.launches`` counts kernel launches."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 1, out)
    if rows_per_chunk is None:
        rows_per_chunk = default_chunk(u.shape)
    launch_stencil("tc_jacobi1d_stream2", u, out, bc, rows_per_chunk)
    step_stream2.launches += 1
    return out


step_stream2.launches = 0


def step_grid(u: torch.Tensor, bc: str = "dirichlet",
              rows_per_chunk: int | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """One 1D step by whole windows: the CUDA kernel for a CUDA tensor,
    ``step_plain`` for a CPU tensor. A CTA owns ``rows_per_chunk`` rows
    of 128 cells (default :func:`default_grid_chunk`). Writes into
    ``out`` (which must not alias ``u``) when given.
    ``step_grid.launches`` counts kernel launches."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 1, out)
    if rows_per_chunk is None:
        rows_per_chunk = default_grid_chunk(u.shape)
    check_staged_smem("grid", grid_smem(1, rows_per_chunk, u.element_size()),
                      rows_per_chunk)
    launch_stencil("tc_jacobi1d_grid", u, out, bc, rows_per_chunk)
    step_grid.launches += 1
    return out


step_grid.launches = 0


def step_wave(u: torch.Tensor, bc: str = "dirichlet",
              rows_per_chunk: int | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """One 1D step by ring-buffered block streams: the CUDA kernel for a
    CUDA tensor, ``step_plain`` for a CPU tensor; dirichlet only, on
    either. A ring block is ``rows_per_chunk`` rows of 128 cells (default
    :func:`default_wave_chunk`). Writes into ``out`` (which must not
    alias ``u``) when given. ``step_wave.launches`` counts kernel
    launches."""
    check_bc(bc)
    check_wave_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 1, out)
    if rows_per_chunk is None:
        rows_per_chunk = default_wave_chunk(u.shape)
    check_staged_smem("wave", wave_smem(1, rows_per_chunk, u.element_size()),
                      rows_per_chunk)
    launch_stencil("tc_jacobi1d_wave", u, out, bc, rows_per_chunk)
    step_wave.launches += 1
    return out


step_wave.launches = 0


def step_block(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 1D step by the whole-field kernel: the CUDA kernel for a CUDA
    tensor, ``step_plain`` for a CPU tensor. Writes into ``out`` (which
    must not alias ``u``) when given. ``step_block.launches`` counts
    kernel launches."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 1, out)
    launch_stencil("tc_jacobi1d_block", u, out, bc)
    step_block.launches += 1
    return out


step_block.launches = 0


def step_multi(u: torch.Tensor, bc: str = "dirichlet", t_steps: int = 8,
               rows_per_chunk: int | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """``t_steps`` 1D steps in one pass: the CUDA kernel for a CUDA
    tensor, ``step_multi_plain`` for a CPU tensor. A block owns
    ``rows_per_chunk`` rows of 128 outputs (default
    :func:`default_multi_chunk`). Writes into ``out`` (which must not
    alias ``u``) when given. ``step_multi.launches`` counts kernel
    launches (more than one a pass beyond ``tiling.MULTI_T_MAX``
    steps)."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_multi_plain(u, bc, t_steps, out)
    out = check_kernel_args(u, 1, out)
    if rows_per_chunk is None:
        rows_per_chunk = default_multi_chunk(u.shape)
    step_multi.launches += launch_multi(
        "tc_jacobi1d_multi", u, out, bc, t_steps, (rows_per_chunk * 128,)
    )
    return out


step_multi.launches = 0

STEPS = {"torch": step_torch, "stream": step_stream, "block": step_block,
         "grid": step_grid, "stream2": step_stream2, "wave": step_wave}
IMPLS = tuple(STEPS)


def run(u0: torch.Tensor, iters: int, bc: str = "dirichlet",
        impl: str = "stream", **kwargs) -> torch.Tensor:
    """Iterate the 1D stencil (shared loop in kernels/__init__)."""
    return run_steps(STEPS[impl], u0, iters, bc, **kwargs)


def run_multi(u0: torch.Tensor, iters: int, bc: str = "dirichlet",
              t_steps: int = 8, **kwargs) -> torch.Tensor:
    """Iterate by temporal blocking, ``iters // t_steps`` passes of
    :func:`step_multi`; ``iters`` must be a multiple of ``t_steps``."""
    return run_steps_multi(step_multi, u0, iters, bc, t_steps, **kwargs)


def run_to_convergence(u0: torch.Tensor, tol: float, max_iters: int,
                       check_every: int = 10, bc: str = "dirichlet",
                       impl: str = "stream", **kwargs):
    """Iterate until the per-step L2 residual reaches ``tol``; returns
    ``(u, iters_run, residual)``."""
    return run_steps_to_convergence(
        STEPS[impl], u0, tol, max_iters, check_every, bc, **kwargs
    )
