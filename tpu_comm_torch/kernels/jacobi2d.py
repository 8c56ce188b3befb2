"""2D 5-point Jacobi step: plain PyTorch versions + hand-written CUDA
kernels.

Port of every arm of ``tpu_comm/kernels/jacobi2d.py``'s ``STEPS`` and of
its ``pallas-multi``: ``lax`` (``step_lax``), ``pallas-stream``
(``step_pallas_stream`` and its kernel ``_jacobi2d_stream_kernel``),
``pallas`` (``step_pallas``, ``_jacobi2d_kernel``), ``pallas-grid``
(``step_pallas_grid``, ``_jacobi2d_grid_kernel`` and its top and bottom
row recompute), ``pallas-wave`` (``step_pallas_wave``,
``_jacobi2d_wave_kernel``), ``pallas-multi`` (``step_pallas_multi``,
its kernel ``_jacobi2d_multi_kernel`` and its edge fix
``_edge_band_fix_multi_2d``) and the mesh ``pallas-wave``'s local update
(``step_pallas_wave_ghost``, ``_jacobi2d_wave_ghost_kernel``, with the
seam-column recompute of JAX's ``make_local_step`` folded in).

Update rule: u'[i,j] = ((u[i-1,j] + u[i+1,j]) + (u[i,j-1] + u[i,j+1])) / 4
Boundary: ``dirichlet`` freezes the one-cell ring; ``periodic`` wraps.

- ``step_plain``  — ``torch.roll`` expression in float32, narrowed once
  (the TPU stream kernel's arithmetic); what the CPU runs.
- ``step_torch``  — JAX's ``step_lax``: plain PyTorch in the field's
  dtype (``kernels/padded.py``), no kernel; the ``torch`` arm.
- ``step_stream`` — the wrapper of ``jacobi2d_kernel`` in
  ``csrc/jacobi_stream.cu``: a CUDA tensor goes to the kernel, a CPU
  tensor to ``step_plain``.
- ``step_grid``   — the wrapper of ``jacobi2d_grid_kernel`` in
  ``csrc/grid.cu``: one window (a tile of rows x 256 columns and its
  halo) a CTA, copied in whole, then computed.
- ``step_wave``   — the wrapper of ``jacobi2d_wave_kernel`` in
  ``csrc/wave.cu``: each CTA streams a range of row blocks of a
  256-column strip through a ring in shared memory. Dirichlet only, on
  every device, as JAX's arm.
- ``step_wave_ghost_plain`` — one star step of a rank's block whose edge
  cells read the four exchanged ghost lines, f32 compute, one narrowing,
  no freeze (the caller applies the bc).
- ``step_wave_ghost`` — the wrapper of ``wave2d_kernel``'s ``kGhost``
  form in ``csrc/wave.cu``: the mesh ``wave`` arm's update. JAX's kernel
  takes the up and down ghost rows and wraps x inside the block, and its
  caller recomputes the two seam columns from the x ghosts in the
  field's dtype (ROADMAP Trap 4); here the kernel takes all four ghost
  lines and computes every cell in f32: the same values in float32, and
  in bfloat16/float16 within 2 ulps on the two seam columns (two levels
  of rounded adds against one rounding; ``tests/test_torch_wave.py``).
- ``step_block``  — the wrapper of ``jacobi2d_block_kernel`` in
  ``csrc/jacobi_block.cu``, the port of the TPU's whole-field kernel:
  the same function by another design (see the source). It is the
  distributed step's ``block`` local update and a single-device arm.
- ``step_multi_plain`` — ``t_steps`` steps of ``step_plain``'s f32
  arithmetic, the dirichlet ring kept every step, narrowed once.
- ``step_multi``  — the wrapper of ``jacobi2d_multi_kernel`` in
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
    MAX_GRID_Y,
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

#: rows of its 32-column strip each CUDA block owns when the caller
#: passes no chunk; it sets the grid size, never the result
STREAM_DEFAULT_ROWS = 128
#: the output tile a CUDA block (one warp) of the multi kernels (5-point
#: and 9-point) owns when the caller passes none, rows and columns: 112
#: columns are one warp's strip at t = 8 (128 window columns less the
#: apron). It sets the grid, never the result.
MULTI_DEFAULT_TILE = (128, 112)


def default_chunk(shape: tuple) -> int:
    """The chunk ``step_stream`` uses when the caller passes none: the
    default strip height, raised where the grid's y extent (at most
    65535 blocks) would not cover the field."""
    return max(STREAM_DEFAULT_ROWS, -(-shape[0] // 65535))


def default_multi_chunk(shape: tuple) -> int:
    """The tile rows ``step_multi`` uses when the caller passes none."""
    del shape
    return MULTI_DEFAULT_TILE[0]


def default_grid_chunk(shape: tuple) -> int:
    """The tile rows of a ``step_grid`` window when the caller passes
    none: sized to shared memory (``tiling.STAGED_SMEM_TARGET``), raised
    where the grid's y extent would not cover the field."""
    return max(staged_default_rows(grid_smem, 2), -(-shape[0] // MAX_GRID_Y))


def default_wave_chunk(shape: tuple) -> int:
    """The rows of a ``step_wave`` ring block when the caller passes none:
    sized to shared memory."""
    del shape
    return staged_default_rows(wave_smem, 2)


def freeze_ring(new: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The dirichlet ring of ``a`` copied into ``new``, in place."""
    new[0, :], new[-1, :] = a[0, :], a[-1, :]
    new[:, 0], new[:, -1] = a[:, 0], a[:, -1]
    return new


def _step_f32(a: torch.Tensor, bc: str) -> torch.Tensor:
    """One step of a float32 field, unrounded."""
    new = (
        (torch.roll(a, 1, 0) + torch.roll(a, -1, 0))
        + (torch.roll(a, 1, 1) + torch.roll(a, -1, 1))
    ) * 0.25
    return freeze_ring(new, a) if bc == "dirichlet" else new


def step_plain(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 2D step in plain PyTorch: f32 compute, one RTNE narrowing."""
    check_bc(bc)
    return narrow_store(_step_f32(f32_compute(u), bc), u.dtype, out)


def step_multi_plain(u: torch.Tensor, bc: str = "dirichlet",
                     t_steps: int = 8,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """``t_steps`` 2D steps in plain PyTorch: f32 compute, one RTNE
    narrowing at the end."""
    return multi_plain(_step_f32, u, bc, t_steps, out)


def launch_multi_2d(symbol: str, u: torch.Tensor, bc: str, t_steps: int,
                    rows_per_chunk: int | None, cols_per_chunk: int | None,
                    out: torch.Tensor | None) -> tuple[torch.Tensor, int]:
    """Launch a 2D multi kernel (``symbol``) on a CUDA field with a tile
    of ``rows_per_chunk`` x ``cols_per_chunk`` outputs (default
    :data:`MULTI_DEFAULT_TILE`); returns ``(out, launches)``."""
    out = check_kernel_args(u, 2, out)
    tile = (
        MULTI_DEFAULT_TILE[0] if rows_per_chunk is None else rows_per_chunk,
        MULTI_DEFAULT_TILE[1] if cols_per_chunk is None else cols_per_chunk,
    )
    return out, launch_multi(symbol, u, out, bc, t_steps, tile)


def step_stream(u: torch.Tensor, bc: str = "dirichlet",
                rows_per_chunk: int | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """One 2D step: the CUDA kernel for a CUDA tensor, ``step_plain`` for
    a CPU tensor. Writes into ``out`` (which must not alias ``u``) when
    given. ``step_stream.launches`` counts kernel launches."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 2, out)
    if rows_per_chunk is None:
        rows_per_chunk = default_chunk(u.shape)
    launch_stencil("tc_jacobi2d_stream", u, out, bc, rows_per_chunk)
    step_stream.launches += 1
    return out


step_stream.launches = 0


def step_torch(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 2D step in plain PyTorch in the field's dtype (JAX's
    ``step_lax``), on any device; no kernel."""
    return padded.step_torch(u, bc, "star", out)


def step_grid(u: torch.Tensor, bc: str = "dirichlet",
              rows_per_chunk: int | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """One 2D step by whole windows: the CUDA kernel for a CUDA tensor,
    ``step_plain`` for a CPU tensor. A CTA owns a tile of
    ``rows_per_chunk`` rows (default :func:`default_grid_chunk`) x 256
    columns. Writes into ``out`` (which must not alias ``u``) when given.
    ``step_grid.launches`` counts kernel launches."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 2, out)
    if rows_per_chunk is None:
        rows_per_chunk = default_grid_chunk(u.shape)
    check_staged_smem("grid", grid_smem(2, rows_per_chunk, u.element_size()),
                      rows_per_chunk)
    if -(-u.shape[0] // max(rows_per_chunk, 1)) > MAX_GRID_Y:
        raise ValueError(
            f"{u.shape[0]} rows need tiles of more than {rows_per_chunk} "
            f"rows (at most {MAX_GRID_Y} tiles down the field)"
        )
    launch_stencil("tc_jacobi2d_grid", u, out, bc, rows_per_chunk)
    step_grid.launches += 1
    return out


step_grid.launches = 0


def step_wave(u: torch.Tensor, bc: str = "dirichlet",
              rows_per_chunk: int | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """One 2D step by ring-buffered row-block streams: the CUDA kernel for
    a CUDA tensor, ``step_plain`` for a CPU tensor; dirichlet only, on
    either. A ring block is ``rows_per_chunk`` rows (default
    :func:`default_wave_chunk`) of a 256-column strip. Writes into
    ``out`` (which must not alias ``u``) when given. ``step_wave.launches``
    counts kernel launches."""
    check_bc(bc)
    check_wave_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 2, out)
    if rows_per_chunk is None:
        rows_per_chunk = default_wave_chunk(u.shape)
    check_staged_smem("wave", wave_smem(2, rows_per_chunk, u.element_size()),
                      rows_per_chunk)
    launch_stencil("tc_jacobi2d_wave", u, out, bc, rows_per_chunk)
    step_wave.launches += 1
    return out


step_wave.launches = 0


def _ghost_lines(u: torch.Tensor, ghosts, out) -> list[torch.Tensor]:
    ny, nx = u.shape
    return check_ghosts(u, ghosts, ((1, nx), (1, nx), (ny, 1), (ny, 1)),
                        "lines (up, down, left, right)", out)


def step_wave_ghost_plain(u: torch.Tensor, up: torch.Tensor,
                          down: torch.Tensor, left: torch.Tensor,
                          right: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """One star step of a rank's 2D block in plain PyTorch, the
    neighbours past its edges the ghost rows ``up`` and ``down`` ((1, nx))
    and columns ``left`` and ``right`` ((ny, 1)): f32 compute, one RTNE
    narrowing, nothing frozen."""
    up, down, left, right = (
        f32_compute(g) for g in _ghost_lines(u, (up, down, left, right), out))
    a = f32_compute(u)
    col = torch.cat([up, a, down], 0)
    row = torch.cat([left, a, right], 1)
    new = (col[:-2] + col[2:]) + (row[:, :-2] + row[:, 2:])
    return narrow_store(new * 0.25, u.dtype, out)


def step_wave_ghost(u: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                    left: torch.Tensor, right: torch.Tensor,
                    rows_per_chunk: int | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """One star step of a rank's 2D block fed by its four ghost lines (the
    rows ``up`` and ``down``, (1, nx); the columns ``left`` and ``right``,
    (ny, 1); the block's dtype and device): the ghost-fed wave kernel for
    a CUDA tensor, :func:`step_wave_ghost_plain` for a CPU tensor. Nothing
    is frozen: the caller applies the bc. A ring block is
    ``rows_per_chunk`` rows (default :func:`default_wave_chunk`) of a
    256-column strip. Writes into ``out`` (which must not alias ``u``)
    when given. ``step_wave_ghost.launches`` counts kernel launches."""
    ghosts = _ghost_lines(u, (up, down, left, right), out)
    if u.device.type == "cpu":
        return step_wave_ghost_plain(u, *ghosts, out=out)
    out = check_kernel_args(u, 2, out, min_extents=(1, 1))
    if rows_per_chunk is None:
        rows_per_chunk = default_wave_chunk(u.shape)
    if rows_per_chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {rows_per_chunk}")
    check_staged_smem("wave", wave_smem(2, rows_per_chunk, u.element_size()),
                      rows_per_chunk)
    launch_kernel("tc_jacobi2d_wave_ghost", u, u.data_ptr(), out.data_ptr(),
                  *(g.data_ptr() for g in ghosts), *u.shape,
                  KERNEL_DTYPE_CODES[u.dtype], rows_per_chunk)
    step_wave_ghost.launches += 1
    return out


step_wave_ghost.launches = 0


def step_block(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 2D step by the whole-field kernel: the CUDA kernel for a CUDA
    tensor, ``step_plain`` for a CPU tensor. Writes into ``out`` (which
    must not alias ``u``) when given. ``step_block.launches`` counts
    kernel launches."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 2, out)
    launch_stencil("tc_jacobi2d_block", u, out, bc)
    step_block.launches += 1
    return out


step_block.launches = 0


def step_multi(u: torch.Tensor, bc: str = "dirichlet", t_steps: int = 8,
               rows_per_chunk: int | None = None,
               cols_per_chunk: int | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """``t_steps`` 2D steps in one pass: the CUDA kernel for a CUDA
    tensor, ``step_multi_plain`` for a CPU tensor. A block owns a tile of
    ``rows_per_chunk`` x ``cols_per_chunk`` outputs. Writes into ``out``
    (which must not alias ``u``) when given. ``step_multi.launches``
    counts kernel launches (more than one a pass beyond
    ``tiling.MULTI_T_MAX`` steps)."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_multi_plain(u, bc, t_steps, out)
    out, n = launch_multi_2d("tc_jacobi2d_multi", u, bc, t_steps,
                             rows_per_chunk, cols_per_chunk, out)
    step_multi.launches += n
    return out


step_multi.launches = 0

STEPS = {"torch": step_torch, "stream": step_stream, "block": step_block,
         "grid": step_grid, "wave": step_wave}
IMPLS = tuple(STEPS)


def run(u0: torch.Tensor, iters: int, bc: str = "dirichlet",
        impl: str = "stream", **kwargs) -> torch.Tensor:
    """Iterate the 2D stencil (shared loop in kernels/__init__)."""
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
