"""1D 3-point Jacobi step: plain PyTorch version + hand-written CUDA kernel.

Port of ``tpu_comm/kernels/jacobi1d.py``'s ``pallas-stream`` arm
(``step_pallas_stream`` and its kernel ``_jacobi1d_stream_kernel``) and
``pallas`` arm (``step_pallas`` and its kernel ``_jacobi1d_kernel``).

Update rule (Jacobi, ping-pong):  u'[i] = (u[i-1] + u[i+1]) / 2
Boundary: ``dirichlet`` freezes u[0] and u[N-1]; ``periodic`` wraps.

- ``step_plain``  — ``torch.roll`` expression in float32, narrowed once.
  It repeats the TPU stream kernel's arithmetic (not JAX's ``step_lax``,
  which adds in the field dtype), and is what the CPU runs.
- ``step_stream`` — the wrapper of ``jacobi1d_kernel`` in
  ``csrc/jacobi_stream.cu``: a CUDA tensor goes to the kernel, a CPU
  tensor to ``step_plain``.
- ``step_block``  — the wrapper of ``jacobi1d_block_kernel`` in
  ``csrc/jacobi_block.cu``, the port of the TPU's whole-field kernel:
  the same function by another design (see the source). It is the
  distributed step's ``block`` local update and a single-device arm.
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

#: default rows of 128 elements each CUDA block covers (the counterpart
#: of the TPU arm's rows_per_chunk); it sets the grid size, never the
#: result. Small chunks mean many blocks, which keeps more loads in flight
STREAM_DEFAULT_ROWS = 8


def default_chunk(shape: tuple) -> int:
    """The chunk ``step_stream`` uses when the caller passes none."""
    del shape
    return STREAM_DEFAULT_ROWS


def step_plain(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 1D step in plain PyTorch: f32 compute, one RTNE narrowing."""
    check_bc(bc)
    a = f32_compute(u)
    new = (torch.roll(a, 1) + torch.roll(a, -1)) * 0.5
    if bc == "dirichlet":
        new[0], new[-1] = a[0], a[-1]
    return narrow_store(new, u.dtype, out)


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

STEPS = {"stream": step_stream, "block": step_block}
IMPLS = tuple(STEPS)


def run(u0: torch.Tensor, iters: int, bc: str = "dirichlet",
        impl: str = "stream", **kwargs) -> torch.Tensor:
    """Iterate the 1D stencil (shared loop in kernels/__init__)."""
    return run_steps(STEPS[impl], u0, iters, bc, **kwargs)


def run_to_convergence(u0: torch.Tensor, tol: float, max_iters: int,
                       check_every: int = 10, bc: str = "dirichlet",
                       impl: str = "stream", **kwargs):
    """Iterate until the per-step L2 residual reaches ``tol``; returns
    ``(u, iters_run, residual)``."""
    return run_steps_to_convergence(
        STEPS[impl], u0, tol, max_iters, check_every, bc, **kwargs
    )
