"""3D 27-point box stencil: plain PyTorch version + hand-written CUDA
kernels.

Port of ``tpu_comm/kernels/stencil27.py``'s ``pallas-stream`` arm
(``step_pallas_stream`` and its kernel ``_stencil27_stream_kernel``),
``pallas`` arm (``step_pallas`` and its kernel ``_stencil27_kernel``) and
``pallas-wave`` arm (``step_pallas_wave`` and its kernel
``_stencil27_wave_kernel``).

Update rule: the mean of the 26 box neighbours,
u' = ((full9(zm) + full9(zp)) + box8(u)) * f32(1/26), where box8 is the
in-plane 8-neighbour sum in the 9-point stencil's association and
full9(p) = box8(p) + p.
Boundary: ``dirichlet`` freezes the one-cell shell; ``periodic`` wraps.

- ``step_torch``  — JAX's ``step_lax``: plain PyTorch in the field's
  dtype (``kernels/padded.py``), no kernel; the ``torch`` arm.
- ``step_plain``  — ``torch.roll`` expression in float32, narrowed once
  (the TPU kernels' arithmetic); what the CPU runs.
- ``step_stream`` — the wrapper of ``stencil27_stream_kernel`` in
  ``csrc/box.cu``: a CUDA tensor goes to the kernel, a CPU tensor to
  ``step_plain``. Any chunk >= 1 is legal (the TPU arm's VMEM limit
  has no counterpart here).
- ``step_block``  — the wrapper of ``stencil27_block_kernel`` in
  ``csrc/box.cu``, the port of the TPU's plane-pipelined kernel. It is
  the distributed step's ``block`` local update and a single-device arm.
- ``step_wave``   — the wrapper of ``stencil27_wave_kernel`` in
  ``csrc/wave.cu``: each CTA streams a z range of a tile (rows of a
  256-column strip) through a ring of plane tiles in shared memory.
  Dirichlet only, on every device, as JAX's arm.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_comm_torch.kernels import run_steps, run_steps_to_convergence
from tpu_comm_torch.kernels.jacobi3d import default_chunk
from tpu_comm_torch.kernels import padded
from tpu_comm_torch.kernels.reference import check_bc
from tpu_comm_torch.kernels.tiling import (
    WAVE3D_MAX_ROWS,
    check_kernel_args,
    check_staged_smem,
    check_wave_bc,
    f32_compute,
    launch_stencil,
    narrow_store,
    staged_default_rows,
    wave_smem,
)

#: the f32 constant of the golden (1/26 rounded once), as an exact float
INV26 = float(np.float32(1.0 / 26.0))


def default_wave_chunk(shape: tuple) -> int:
    """The tile rows of a ``step_wave`` CTA when the caller passes none:
    the most, a multiple of 8, whose float32 ring fits
    ``tiling.STAGED_SMEM_TARGET``. It sets the grid, never the result."""
    del shape
    return staged_default_rows(wave_smem, 3)


def _box8(p: torch.Tensor) -> torch.Tensor:
    """The in-plane 8-neighbour sum over the last two axes (the 9-point
    stencil's association)."""
    up = torch.roll(p, 1, 1)
    down = torch.roll(p, -1, 1)
    return ((up + down) + (torch.roll(p, 1, 2) + torch.roll(p, -1, 2))) + (
        (torch.roll(up, 1, 2) + torch.roll(down, -1, 2))
        + (torch.roll(up, -1, 2) + torch.roll(down, 1, 2))
    )


def step_plain(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 27-point step in plain PyTorch: f32 compute, one RTNE
    narrowing."""
    check_bc(bc)
    a = f32_compute(u)
    zm = torch.roll(a, 1, 0)
    zp = torch.roll(a, -1, 0)
    new = (((_box8(zm) + zm) + (_box8(zp) + zp)) + _box8(a)) * INV26
    if bc == "dirichlet":
        new[0], new[-1] = a[0], a[-1]
        new[:, 0], new[:, -1] = a[:, 0], a[:, -1]
        new[:, :, 0], new[:, :, -1] = a[:, :, 0], a[:, :, -1]
    return narrow_store(new, u.dtype, out)


def step_stream(u: torch.Tensor, bc: str = "dirichlet",
                planes_per_chunk: int | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """One 27-point step by the stream kernel: the CUDA kernel for a CUDA
    tensor, ``step_plain`` for a CPU tensor. ``planes_per_chunk`` (default
    :func:`default_chunk`, the 7-point stream's) sets the launch grid,
    never the result. Writes into ``out`` (which must not alias ``u``)
    when given. ``step_stream.launches`` counts kernel launches."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 3, out, min_extents=(2, 3, 3))
    if planes_per_chunk is None:
        planes_per_chunk = default_chunk(u.shape)
    launch_stencil("tc_stencil27_stream", u, out, bc, planes_per_chunk)
    step_stream.launches += 1
    return out


step_stream.launches = 0


def step_block(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 27-point step by the whole-field kernel: the CUDA kernel for a
    CUDA tensor, ``step_plain`` for a CPU tensor. Writes into ``out``
    (which must not alias ``u``) when given. ``step_block.launches``
    counts kernel launches."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 3, out, min_extents=(2, 3, 3))
    launch_stencil("tc_stencil27_block", u, out, bc)
    step_block.launches += 1
    return out


step_block.launches = 0


def step_wave(u: torch.Tensor, bc: str = "dirichlet",
              rows_per_chunk: int | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """One 27-point step by ring-buffered plane-tile streams: the CUDA
    kernel for a CUDA tensor, ``step_plain`` for a CPU tensor; dirichlet
    only, on either. A CTA owns a tile of ``rows_per_chunk`` rows (default
    :func:`default_wave_chunk`, at most ``tiling.WAVE3D_MAX_ROWS``) of a
    256-column strip and a range of its planes. Writes into ``out`` (which
    must not alias ``u``) when given. ``step_wave.launches`` counts kernel
    launches."""
    check_bc(bc)
    check_wave_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 3, out, min_extents=(2, 3, 3))
    if rows_per_chunk is None:
        rows_per_chunk = default_wave_chunk(u.shape)
    check_staged_smem("wave", wave_smem(3, rows_per_chunk, u.element_size()),
                      rows_per_chunk)
    if rows_per_chunk > WAVE3D_MAX_ROWS:
        raise ValueError(
            f"chunk {rows_per_chunk}: the 27-point wave kernel keeps a tile "
            f"row's sums in registers, at most {WAVE3D_MAX_ROWS} rows"
        )
    launch_stencil("tc_stencil27_wave", u, out, bc, rows_per_chunk)
    step_wave.launches += 1
    return out


step_wave.launches = 0

def step_torch(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 27-point step in plain PyTorch in the field's dtype (JAX's
    ``step_lax``), on any device; no kernel."""
    return padded.step_torch(u, bc, "27pt", out)


STEPS = {"torch": step_torch, "stream": step_stream, "block": step_block,
         "wave": step_wave}
IMPLS = tuple(STEPS)


def run(u0: torch.Tensor, iters: int, bc: str = "dirichlet",
        impl: str = "stream", **kwargs) -> torch.Tensor:
    """Iterate the 27-point stencil (shared loop in kernels/__init__)."""
    return run_steps(STEPS[impl], u0, iters, bc, **kwargs)


def run_to_convergence(u0: torch.Tensor, tol: float, max_iters: int,
                       check_every: int = 10, bc: str = "dirichlet",
                       impl: str = "stream", **kwargs):
    """Iterate until the per-step L2 residual reaches ``tol``; returns
    ``(u, iters_run, residual)``."""
    return run_steps_to_convergence(
        STEPS[impl], u0, tol, max_iters, check_every, bc, **kwargs
    )
