"""3D 7-point Jacobi step: plain PyTorch version + hand-written CUDA kernel.

Port of ``tpu_comm/kernels/jacobi3d.py``'s ``pallas-stream`` arm
(``step_pallas_stream`` and its kernel ``_jacobi3d_stream_kernel``),
``pallas`` arm (``step_pallas`` and its kernel ``_jacobi3d_kernel``) and
``pallas-multi`` (``step_pallas_multi`` and its kernel
``_jacobi3d_wave_kernel``, the 3.5D wavefront).

Update rule: u' = (((zm + zp) + (ym + yp)) + (xm + xp)) * f32(1/6)
Boundary: ``dirichlet`` freezes the one-cell shell; ``periodic`` wraps.

- ``step_torch``  — JAX's ``step_lax``: plain PyTorch in the field's
  dtype (``kernels/padded.py``), no kernel; the ``torch`` arm.
- ``step_plain``  — ``torch.roll`` expression in float32, narrowed once
  (the TPU stream kernel's arithmetic); what the CPU runs.
- ``step_stream`` — the wrapper of ``jacobi3d_kernel`` in
  ``csrc/jacobi_stream.cu``: a CUDA tensor goes to the kernel, a CPU
  tensor to ``step_plain``.
- ``step_block``  — the wrapper of ``jacobi3d_block_kernel`` in
  ``csrc/jacobi_block.cu``, the port of the TPU's whole-field kernel:
  the same function by another design (see the source). It is the
  distributed step's ``block`` local update and a single-device arm.
- ``step_multi_plain`` — ``t_steps`` steps of ``step_plain``'s f32
  arithmetic, the shell kept every step, narrowed once.
- ``step_multi``  — the wrapper of ``jacobi3d_multi_kernel`` in
  ``csrc/multi.cu`` (the wavefront: ``t_steps`` steps in one z-marching
  pass, a block per (y, x) tile with a t-cell apron); the single-device
  ``multi`` arm, through :func:`run_multi`. Dirichlet only, on every
  device, as JAX's arm.
"""

from __future__ import annotations

import numpy as np
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
    MULTI_T_MAX,
    check_kernel_args,
    check_multi3d_bc,
    f32_compute,
    launch_multi,
    launch_stencil,
    multi3d_default_tile,
    narrow_store,
)

#: z-planes each CUDA block marches over when the caller passes no chunk
#: (the counterpart of the TPU kernel's zb); it sets the grid and how
#: often chunk-edge planes are re-read, never the result
STREAM_DEFAULT_PLANES = 8
#: the f32 constant of the golden (1/6 rounded once), as an exact float
SIXTH = float(np.float32(1.0 / 6.0))
#: the output tile a CUDA block of the wavefront owns when the caller
#: passes none, rows and columns, at the most steps a launch runs
#: (``tiling.MULTI_T_MAX[3]``): with its apron the most window a block
#: holds, 32 x 64 cells, 512 threads of 4 rows each (at other steps
#: ``tiling.multi3d_default_tile``).
#: It sets the grid, never the result.
MULTI_DEFAULT_TILE = multi3d_default_tile(MULTI_T_MAX[3])


def default_chunk(shape: tuple) -> int:
    """The chunk ``step_stream`` uses when the caller passes none: the
    default depth, raised where the grid's z extent (at most 65535
    blocks) would not cover the field."""
    return max(STREAM_DEFAULT_PLANES, -(-shape[0] // 65535))


def default_multi_chunk(shape: tuple) -> int:
    """The tile rows ``step_multi`` uses when the caller passes none."""
    del shape
    return MULTI_DEFAULT_TILE[0]


def _step_f32(a: torch.Tensor, bc: str) -> torch.Tensor:
    """One 3D step of a float32 field, unrounded."""
    new = (
        (torch.roll(a, 1, 0) + torch.roll(a, -1, 0))
        + (torch.roll(a, 1, 1) + torch.roll(a, -1, 1))
        + (torch.roll(a, 1, 2) + torch.roll(a, -1, 2))
    ) * SIXTH
    if bc == "dirichlet":
        new[0], new[-1] = a[0], a[-1]
        new[:, 0], new[:, -1] = a[:, 0], a[:, -1]
        new[:, :, 0], new[:, :, -1] = a[:, :, 0], a[:, :, -1]
    return new


def step_plain(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 3D step in plain PyTorch: f32 compute, one RTNE narrowing."""
    check_bc(bc)
    return narrow_store(_step_f32(f32_compute(u), bc), u.dtype, out)


def step_multi_plain(u: torch.Tensor, bc: str = "dirichlet",
                     t_steps: int = 4,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """``t_steps`` 3D steps in plain PyTorch: f32 compute, one RTNE
    narrowing at the end."""
    return multi_plain(_step_f32, u, bc, t_steps, out)


def step_stream(u: torch.Tensor, bc: str = "dirichlet",
                planes_per_chunk: int | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """One 3D step: the CUDA kernel for a CUDA tensor, ``step_plain`` for
    a CPU tensor. Writes into ``out`` (which must not alias ``u``) when
    given. ``step_stream.launches`` counts kernel launches."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 3, out)
    if planes_per_chunk is None:
        planes_per_chunk = default_chunk(u.shape)
    launch_stencil("tc_jacobi3d_stream", u, out, bc, planes_per_chunk)
    step_stream.launches += 1
    return out


step_stream.launches = 0


def step_block(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 3D step by the whole-field kernel: the CUDA kernel for a CUDA
    tensor, ``step_plain`` for a CPU tensor. Writes into ``out`` (which
    must not alias ``u``) when given. ``step_block.launches`` counts
    kernel launches."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 3, out, min_extents=(2, 3, 3))
    launch_stencil("tc_jacobi3d_block", u, out, bc)
    step_block.launches += 1
    return out


step_block.launches = 0


def step_multi(u: torch.Tensor, bc: str = "dirichlet", t_steps: int = 4,
               rows_per_chunk: int | None = None,
               cols_per_chunk: int | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """``t_steps`` 3D steps in one z-marching pass: the CUDA kernel for a
    CUDA tensor, ``step_multi_plain`` for a CPU tensor; dirichlet only, on
    either (JAX's default t is 4). A block owns a tile of
    ``rows_per_chunk`` x ``cols_per_chunk`` outputs (default
    ``tiling.multi3d_default_tile`` at the pass's steps,
    :data:`MULTI_DEFAULT_TILE` at 4; a tile larger than a block holds is cut,
    ``tiling.multi3d_block_tile``) and marches z. Writes into ``out`` (which
    must not alias ``u``) when given. ``step_multi.launches`` counts
    kernel launches (more than one a pass beyond ``tiling.MULTI_T_MAX``
    steps)."""
    check_bc(bc)
    check_multi3d_bc(bc)
    if u.device.type == "cpu":
        return step_multi_plain(u, bc, t_steps, out)
    out = check_kernel_args(u, 3, out, min_extents=(2, 3, 3))
    default = multi3d_default_tile(min(t_steps, MULTI_T_MAX[3]))
    tile = (
        default[0] if rows_per_chunk is None else rows_per_chunk,
        default[1] if cols_per_chunk is None else cols_per_chunk,
    )
    step_multi.launches += launch_multi("tc_jacobi3d_multi", u, out, bc,
                                        t_steps, tile)
    return out


step_multi.launches = 0

def step_torch(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 3D step in plain PyTorch in the field's dtype (JAX's
    ``step_lax``), on any device; no kernel."""
    return padded.step_torch(u, bc, "star", out)


STEPS = {"torch": step_torch, "stream": step_stream, "block": step_block}
IMPLS = tuple(STEPS)


def run(u0: torch.Tensor, iters: int, bc: str = "dirichlet",
        impl: str = "stream", **kwargs) -> torch.Tensor:
    """Iterate the 3D stencil (shared loop in kernels/__init__)."""
    return run_steps(STEPS[impl], u0, iters, bc, **kwargs)


def run_multi(u0: torch.Tensor, iters: int, bc: str = "dirichlet",
              t_steps: int = 4, **kwargs) -> torch.Tensor:
    """Iterate by the wavefront, ``iters // t_steps`` passes of
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
