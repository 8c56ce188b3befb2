"""Stencil kernels and the shared step loops.

Port of ``tpu_comm/kernels/__init__.py``. PyTorch runs eagerly, so the
JAX package's jitted ``fori_loop``/``while_loop`` become Python loops
that launch one kernel per step.
"""

from __future__ import annotations

import torch

from tpu_comm_torch.kernels.reference import check_bc
from tpu_comm_torch.kernels.tiling import (
    check_t_steps,
    f32_compute,
    narrow_store,
)

#: the box stencils: the distributed step's ``stencil`` name (the JAX
#: ``make_local_step``'s) -> (field dim, ``--points``); the one table
#: that links the two spellings
BOX = {"9pt": (2, 9), "27pt": (3, 27)}


def stencil_name(points: int) -> str:
    """The distributed step's ``stencil`` for ``--points`` (0: the
    star)."""
    return {0: "star", **{p: name for name, (_, p) in BOX.items()}}[points]


def run_steps(step, u0: torch.Tensor, iters: int, bc: str,
              **kwargs) -> torch.Tensor:
    """Iterate ``step`` ``iters`` times from ``u0``; returns the field.

    Ping-pong over two buffers allocated once per call: each step writes
    into the buffer the step before last wrote (in-place reuse), so the
    loop allocates nothing after its start. ``u0`` itself is only read.
    """
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if iters == 0:
        return u0.clone()
    bufs = (torch.empty_like(u0), torch.empty_like(u0))
    src = u0
    for i in range(iters):
        src = step(src, bc=bc, out=bufs[i % 2], **kwargs)
    return src


def run_steps_multi(step_multi, u0: torch.Tensor, iters: int, bc: str,
                    t_steps: int, **kwargs) -> torch.Tensor:
    """Iterate a temporal-blocking ``step_multi``: each call advances
    ``t_steps`` iterations, so the loop runs ``iters // t_steps`` fused
    passes over :func:`run_steps`' two buffers. ``iters`` must be a
    multiple of ``t_steps``."""
    check_t_steps(t_steps)
    if iters % t_steps != 0:
        raise ValueError(
            f"iters={iters} must be a multiple of t_steps={t_steps}"
        )
    return run_steps(step_multi, u0, iters // t_steps, bc, t_steps=t_steps,
                     **kwargs)


def multi_plain(step_f32, u: torch.Tensor, bc: str, t_steps: int,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """``t_steps`` applications of ``step_f32(a, bc)`` (one unrounded
    float32 step) to ``u`` widened to f32, then one RTNE narrowing (into
    ``out`` when given): the plain version of every multi kernel."""
    check_bc(bc)
    check_t_steps(t_steps)
    a = f32_compute(u)
    for _ in range(t_steps):
        a = step_f32(a, bc)
    return narrow_store(a, u.dtype, out)


def run_steps_to_convergence(
    step, u0: torch.Tensor, tol: float, max_iters: int,
    check_every: int = 10, bc: str = "dirichlet", **kwargs,
) -> tuple[torch.Tensor, int, float]:
    """Iterate until the per-step L2 residual reaches ``tol``.

    Every ``check_every`` steps, the last step's change (taken in the
    field dtype, cast to float32, squared and summed in float32) is read
    back to the host; the loop stops when it is ``<= tol`` or after
    ``max_iters`` total steps, as ``reference.jacobi_run_to_convergence``
    does. Same ping-pong buffers as :func:`run_steps`. Returns
    ``(u, iters_run, residual)``.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    bufs = (torch.empty_like(u0), torch.empty_like(u0))
    src = u0
    n = 0
    it = 0
    res = float("inf")
    while it < max_iters and res > tol:
        for _ in range(check_every - 1):
            src = step(src, bc=bc, out=bufs[n % 2], **kwargs)
            n += 1
        new = step(src, bc=bc, out=bufs[n % 2], **kwargs)
        n += 1
        d = (new - src).float()
        res = float(torch.sqrt(torch.sum(d * d, dtype=torch.float32)))
        src = new
        it += check_every
    return (src if n else u0.clone()), it, res


def launch_wrappers() -> list:
    """Every kernel wrapper of the port: each function of the kernel
    modules with a ``launches`` count (one added where it launches its
    kernel)."""
    from tpu_comm_torch.kernels import (
        jacobi1d,
        jacobi2d,
        jacobi3d,
        membw,
        pack,
        stencil9,
        stencil27,
    )

    found = {}
    for mod in (jacobi1d, jacobi2d, jacobi3d, stencil9, stencil27, pack,
                membw):
        for obj in vars(mod).values():
            if callable(obj) and hasattr(obj, "launches"):
                found[id(obj)] = obj
    return list(found.values())


def kernels_for(dim: int, points: int = 0):
    """Kernel module of a stencil (step_plain / step_stream / step_block /
    run, and where the family has temporal blocking step_multi_plain /
    step_multi / run_multi): the star of ``dim`` for ``points`` 0, the 2D
    9-point or 3D 27-point box otherwise (the JAX driver's
    ``_kernels_for``, with its messages)."""
    if points == 0:
        if dim == 1:
            from tpu_comm_torch.kernels import jacobi1d as mod
        elif dim == 2:
            from tpu_comm_torch.kernels import jacobi2d as mod
        elif dim == 3:
            from tpu_comm_torch.kernels import jacobi3d as mod
        else:
            raise ValueError(f"dim must be 1, 2 or 3, got {dim}")
    elif points == 9:
        if dim != 2:
            raise ValueError("--points 9 (the 2D box stencil) needs --dim 2")
        from tpu_comm_torch.kernels import stencil9 as mod
    elif points == 27:
        if dim != 3:
            raise ValueError(
                "--points 27 (the 3D box stencil) needs --dim 3"
            )
        from tpu_comm_torch.kernels import stencil27 as mod
    else:
        raise ValueError(
            f"--points must be 9 (2D box) or 27 (3D box; omit for the "
            f"star), got {points}"
        )
    return mod
