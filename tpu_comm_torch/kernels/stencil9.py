"""2D 9-point box stencil: plain PyTorch version + hand-written CUDA kernels.

Port of ``tpu_comm/kernels/stencil9.py``'s ``pallas-stream`` arm
(``step_pallas_stream`` and its kernel ``_stencil9_stream_kernel``) and
``pallas`` arm (``step_pallas`` and its kernel ``_stencil9_kernel``).

Update rule: the mean of the 8 box neighbours,
u' = (((up + down) + (left + right)) + ((ul + dr) + (ur + dl))) * 1/8,
the diagonals being horizontal rolls of the row-shifted arrays.
Boundary: ``dirichlet`` freezes the one-cell ring; ``periodic`` wraps.

- ``step_plain``  — ``torch.roll`` expression in float32, narrowed once
  (the TPU kernels' arithmetic); what the CPU runs.
- ``step_stream`` — the wrapper of ``stencil9_stream_kernel`` in
  ``csrc/box.cu``: a CUDA tensor goes to the kernel, a CPU tensor to
  ``step_plain``.
- ``step_block``  — the wrapper of ``stencil9_block_kernel`` in
  ``csrc/box.cu``, the port of the TPU's whole-field kernel. It is the
  distributed step's ``block`` local update and a single-device arm.
"""

from __future__ import annotations

import torch

from tpu_comm_torch.kernels import run_steps, run_steps_to_convergence
from tpu_comm_torch.kernels.jacobi2d import default_chunk
from tpu_comm_torch.kernels.reference import check_bc
from tpu_comm_torch.kernels.tiling import (
    check_kernel_args,
    f32_compute,
    launch_stencil,
    narrow_store,
)


def step_plain(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 9-point step in plain PyTorch: f32 compute, one RTNE
    narrowing."""
    check_bc(bc)
    a = f32_compute(u)
    up = torch.roll(a, 1, 0)
    down = torch.roll(a, -1, 0)
    new = (
        ((up + down) + (torch.roll(a, 1, 1) + torch.roll(a, -1, 1)))
        + ((torch.roll(up, 1, 1) + torch.roll(down, -1, 1))
           + (torch.roll(up, -1, 1) + torch.roll(down, 1, 1)))
    ) * 0.125
    if bc == "dirichlet":
        new[0, :], new[-1, :] = a[0, :], a[-1, :]
        new[:, 0], new[:, -1] = a[:, 0], a[:, -1]
    return narrow_store(new, u.dtype, out)


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

STEPS = {"stream": step_stream, "block": step_block}
IMPLS = tuple(STEPS)


def run(u0: torch.Tensor, iters: int, bc: str = "dirichlet",
        impl: str = "stream", **kwargs) -> torch.Tensor:
    """Iterate the 9-point stencil (shared loop in kernels/__init__)."""
    return run_steps(STEPS[impl], u0, iters, bc, **kwargs)


def run_to_convergence(u0: torch.Tensor, tol: float, max_iters: int,
                       check_every: int = 10, bc: str = "dirichlet",
                       impl: str = "stream", **kwargs):
    """Iterate until the per-step L2 residual reaches ``tol``; returns
    ``(u, iters_run, residual)``."""
    return run_steps_to_convergence(
        STEPS[impl], u0, tol, max_iters, check_every, bc, **kwargs
    )
