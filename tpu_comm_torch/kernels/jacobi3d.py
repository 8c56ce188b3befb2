"""3D 7-point Jacobi step: plain PyTorch version + hand-written CUDA kernel.

Port of ``tpu_comm/kernels/jacobi3d.py``'s ``pallas-stream`` arm
(``step_pallas_stream`` and its kernel ``_jacobi3d_stream_kernel``) and
``pallas`` arm (``step_pallas`` and its kernel ``_jacobi3d_kernel``).

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
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_comm_torch.kernels import run_steps, run_steps_to_convergence
from tpu_comm_torch.kernels import padded
from tpu_comm_torch.kernels.reference import check_bc
from tpu_comm_torch.kernels.tiling import (
    check_kernel_args,
    f32_compute,
    launch_stencil,
    narrow_store,
)

#: z-planes each CUDA block marches over when the caller passes no chunk
#: (the counterpart of the TPU kernel's zb); it sets the grid and how
#: often chunk-edge planes are re-read, never the result
STREAM_DEFAULT_PLANES = 8
#: the f32 constant of the golden (1/6 rounded once), as an exact float
SIXTH = float(np.float32(1.0 / 6.0))


def default_chunk(shape: tuple) -> int:
    """The chunk ``step_stream`` uses when the caller passes none: the
    default depth, raised where the grid's z extent (at most 65535
    blocks) would not cover the field."""
    return max(STREAM_DEFAULT_PLANES, -(-shape[0] // 65535))


def step_plain(u: torch.Tensor, bc: str = "dirichlet",
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One 3D step in plain PyTorch: f32 compute, one RTNE narrowing."""
    check_bc(bc)
    a = f32_compute(u)
    new = (
        (torch.roll(a, 1, 0) + torch.roll(a, -1, 0))
        + (torch.roll(a, 1, 1) + torch.roll(a, -1, 1))
        + (torch.roll(a, 1, 2) + torch.roll(a, -1, 2))
    ) * SIXTH
    if bc == "dirichlet":
        new[0], new[-1] = a[0], a[-1]
        new[:, 0], new[:, -1] = a[:, 0], a[:, -1]
        new[:, :, 0], new[:, :, -1] = a[:, :, 0], a[:, :, -1]
    return narrow_store(new, u.dtype, out)


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


def run_to_convergence(u0: torch.Tensor, tol: float, max_iters: int,
                       check_every: int = 10, bc: str = "dirichlet",
                       impl: str = "stream", **kwargs):
    """Iterate until the per-step L2 residual reaches ``tol``; returns
    ``(u, iters_run, residual)``."""
    return run_steps_to_convergence(
        STEPS[impl], u0, tol, max_iters, check_every, bc, **kwargs
    )
