"""2D 5-point Jacobi step: plain PyTorch version + hand-written CUDA kernel.

Port of ``tpu_comm/kernels/jacobi2d.py``'s ``pallas-stream`` arm
(``step_pallas_stream`` and its kernel ``_jacobi2d_stream_kernel``).

Update rule: u'[i,j] = ((u[i-1,j] + u[i+1,j]) + (u[i,j-1] + u[i,j+1])) / 4
Boundary: ``dirichlet`` freezes the one-cell ring; ``periodic`` wraps.

- ``step_plain``  — ``torch.roll`` expression in float32, narrowed once
  (the TPU stream kernel's arithmetic); what the CPU runs.
- ``step_stream`` — the wrapper of ``jacobi2d_kernel`` in
  ``csrc/jacobi_stream.cu``: a CUDA tensor goes to the kernel, a CPU
  tensor to ``step_plain``.
"""

from __future__ import annotations

import torch

from tpu_comm_torch.kernels import run_steps, run_steps_to_convergence
from tpu_comm_torch.kernels.reference import check_bc
from tpu_comm_torch.kernels.tiling import (
    check_kernel_args,
    f32_compute,
    launch_stencil,
    narrow_store,
)

#: rows of its 32-column strip each CUDA block owns when the caller
#: passes no chunk; it sets the grid size, never the result
STREAM_DEFAULT_ROWS = 128


def default_chunk(shape: tuple) -> int:
    """The chunk ``step_stream`` uses when the caller passes none: the
    default strip height, raised where the grid's y extent (at most
    65535 blocks) would not cover the field."""
    return max(STREAM_DEFAULT_ROWS, -(-shape[0] // 65535))


def step_plain(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 2D step in plain PyTorch: f32 compute, one RTNE narrowing."""
    check_bc(bc)
    a = f32_compute(u)
    new = (
        (torch.roll(a, 1, 0) + torch.roll(a, -1, 0))
        + (torch.roll(a, 1, 1) + torch.roll(a, -1, 1))
    ) * 0.25
    if bc == "dirichlet":
        new[0, :], new[-1, :] = a[0, :], a[-1, :]
        new[:, 0], new[:, -1] = a[:, 0], a[:, -1]
    return narrow_store(new, u.dtype, out)


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

STEPS = {"stream": step_stream}
IMPLS = tuple(STEPS)


def run(u0: torch.Tensor, iters: int, bc: str = "dirichlet",
        impl: str = "stream", **kwargs) -> torch.Tensor:
    """Iterate the 2D stencil (shared loop in kernels/__init__)."""
    return run_steps(STEPS[impl], u0, iters, bc, **kwargs)


def run_to_convergence(u0: torch.Tensor, tol: float, max_iters: int,
                       check_every: int = 10, bc: str = "dirichlet",
                       impl: str = "stream", **kwargs):
    """Iterate until the per-step L2 residual reaches ``tol``; returns
    ``(u, iters_run, residual)``."""
    return run_steps_to_convergence(
        STEPS[impl], u0, tol, max_iters, check_every, bc, **kwargs
    )
