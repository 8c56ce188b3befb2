"""2D 9-point box stencil: plain PyTorch version + hand-written CUDA kernels.

Port of ``tpu_comm/kernels/stencil9.py``'s ``pallas-stream`` arm
(``step_pallas_stream`` and its kernel ``_stencil9_stream_kernel``),
``pallas`` arm (``step_pallas`` and its kernel ``_stencil9_kernel``),
``pallas-wave`` arm (``step_pallas_wave`` and its kernel
``_stencil9_wave_kernel``) and ``pallas-multi`` arm
(``step_pallas_multi``, its kernel ``_stencil9_multi_kernel`` and its
edge fix ``_box_edge_band_fix_multi``).

Update rule: the mean of the 8 box neighbours,
u' = (((up + down) + (left + right)) + ((ul + dr) + (ur + dl))) * 1/8,
the diagonals being horizontal rolls of the row-shifted arrays.
Boundary: ``dirichlet`` freezes the one-cell ring; ``periodic`` wraps.

- ``step_torch``  — JAX's ``step_lax``: plain PyTorch in the field's
  dtype (``kernels/padded.py``), no kernel; the ``torch`` arm.
- ``step_plain``  — ``torch.roll`` expression in float32, narrowed once
  (the TPU kernels' arithmetic); what the CPU runs.
- ``step_stream`` — the wrapper of ``stencil9_stream_kernel`` in
  ``csrc/box.cu``: a CUDA tensor goes to the kernel, a CPU tensor to
  ``step_plain``.
- ``step_block``  — the wrapper of ``stencil9_block_kernel`` in
  ``csrc/box.cu``, the port of the TPU's whole-field kernel. It is the
  distributed step's ``block`` local update and a single-device arm.
- ``step_wave``   — the wrapper of ``wave2d_kernel<T, kBox = true>`` in
  ``csrc/wave.cu``: each CTA streams a range of row blocks of a
  256-column strip through a ring in shared memory (the 2D star's wave
  with the box sum). Dirichlet only, on every device, as JAX's arm.
- ``step_multi_plain`` — ``t_steps`` steps of ``step_plain``'s f32
  arithmetic, the dirichlet ring kept every step, narrowed once.
- ``step_multi``  — the wrapper of ``stencil9_multi_kernel`` in
  ``csrc/multi.cu`` (temporal blocking: ``t_steps`` steps in one pass,
  the 2D star's tiling); the single-device ``multi`` arm, through
  :func:`run_multi`.
"""

from __future__ import annotations

import torch

from tpu_comm_torch.kernels import (
    multi_plain,
    run_steps,
    run_steps_multi,
    run_steps_to_convergence,
)
# the 5-point kernels' chunk and tile defaults are the box's too (the
# driver reads them from this module)
from tpu_comm_torch.kernels.jacobi2d import (  # noqa: F401
    default_chunk,
    default_multi_chunk,
    default_wave_chunk,
    freeze_ring,
    launch_multi_2d,
)
from tpu_comm_torch.kernels import padded
from tpu_comm_torch.kernels.reference import check_bc
from tpu_comm_torch.kernels.tiling import (
    check_kernel_args,
    check_staged_smem,
    check_wave_bc,
    f32_compute,
    launch_stencil,
    narrow_store,
    wave_smem,
)


def _step_f32(a: torch.Tensor, bc: str) -> torch.Tensor:
    """One 9-point step of a float32 field, unrounded."""
    up = torch.roll(a, 1, 0)
    down = torch.roll(a, -1, 0)
    new = (
        ((up + down) + (torch.roll(a, 1, 1) + torch.roll(a, -1, 1)))
        + ((torch.roll(up, 1, 1) + torch.roll(down, -1, 1))
           + (torch.roll(up, -1, 1) + torch.roll(down, 1, 1)))
    ) * 0.125
    return freeze_ring(new, a) if bc == "dirichlet" else new


def step_plain(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 9-point step in plain PyTorch: f32 compute, one RTNE
    narrowing."""
    check_bc(bc)
    return narrow_store(_step_f32(f32_compute(u), bc), u.dtype, out)


def step_multi_plain(u: torch.Tensor, bc: str = "dirichlet",
                     t_steps: int = 8,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """``t_steps`` 9-point steps in plain PyTorch: f32 compute, one RTNE
    narrowing at the end."""
    return multi_plain(_step_f32, u, bc, t_steps, out)


def step_stream(u: torch.Tensor, bc: str = "dirichlet",
                rows_per_chunk: int | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """One 9-point step by the stream kernel: the CUDA kernel for a CUDA
    tensor, ``step_plain`` for a CPU tensor. ``rows_per_chunk`` (default
    :func:`default_chunk`, the 5-point stream's) sets the launch grid,
    never the result. Writes into ``out`` (which must not alias ``u``)
    when given. ``step_stream.launches`` counts kernel launches."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 2, out)
    if rows_per_chunk is None:
        rows_per_chunk = default_chunk(u.shape)
    launch_stencil("tc_stencil9_stream", u, out, bc, rows_per_chunk)
    step_stream.launches += 1
    return out


step_stream.launches = 0


def step_block(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 9-point step by the whole-field kernel: the CUDA kernel for a
    CUDA tensor, ``step_plain`` for a CPU tensor. Writes into ``out``
    (which must not alias ``u``) when given. ``step_block.launches``
    counts kernel launches."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 2, out)
    launch_stencil("tc_stencil9_block", u, out, bc)
    step_block.launches += 1
    return out


step_block.launches = 0


def step_wave(u: torch.Tensor, bc: str = "dirichlet",
              rows_per_chunk: int | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """One 9-point step by ring-buffered row-block streams: the CUDA
    kernel for a CUDA tensor, ``step_plain`` for a CPU tensor; dirichlet
    only, on either. A ring block is ``rows_per_chunk`` rows (default
    :func:`default_wave_chunk`, the 5-point wave's) of a 256-column strip.
    Writes into ``out`` (which must not alias ``u``) when given.
    ``step_wave.launches`` counts kernel launches."""
    check_bc(bc)
    check_wave_bc(bc)
    if u.device.type == "cpu":
        return step_plain(u, bc, out)
    out = check_kernel_args(u, 2, out)
    if rows_per_chunk is None:
        rows_per_chunk = default_wave_chunk(u.shape)
    check_staged_smem("wave", wave_smem(2, rows_per_chunk, u.element_size()),
                      rows_per_chunk)
    launch_stencil("tc_stencil9_wave", u, out, bc, rows_per_chunk)
    step_wave.launches += 1
    return out


step_wave.launches = 0


def step_multi(u: torch.Tensor, bc: str = "dirichlet", t_steps: int = 8,
               rows_per_chunk: int | None = None,
               cols_per_chunk: int | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """``t_steps`` 9-point steps in one pass: the CUDA kernel for a CUDA
    tensor, ``step_multi_plain`` for a CPU tensor. A block owns a tile of
    ``rows_per_chunk`` x ``cols_per_chunk`` outputs. Writes into ``out``
    (which must not alias ``u``) when given. ``step_multi.launches``
    counts kernel launches (more than one a pass beyond
    ``tiling.MULTI_T_MAX`` steps)."""
    check_bc(bc)
    if u.device.type == "cpu":
        return step_multi_plain(u, bc, t_steps, out)
    out, n = launch_multi_2d("tc_stencil9_multi", u, bc, t_steps,
                             rows_per_chunk, cols_per_chunk, out)
    step_multi.launches += n
    return out


step_multi.launches = 0

def step_torch(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 9-point step in plain PyTorch in the field's dtype (JAX's
    ``step_lax``), on any device; no kernel."""
    return padded.step_torch(u, bc, "9pt", out)


STEPS = {"torch": step_torch, "stream": step_stream, "block": step_block,
         "wave": step_wave}
IMPLS = tuple(STEPS)


def run(u0: torch.Tensor, iters: int, bc: str = "dirichlet",
        impl: str = "stream", **kwargs) -> torch.Tensor:
    """Iterate the 9-point stencil (shared loop in kernels/__init__)."""
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
