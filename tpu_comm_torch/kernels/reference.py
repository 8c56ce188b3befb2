"""Serial NumPy golden for the Jacobi stencils (the port's own copy).

The same functions as ``tpu_comm/kernels/reference.py`` for the 1D
3-point, 2D 5-point and 3D 7-point star stencils and the 2D 9-point and
3D 27-point box stencils, kept here so that the port imports nothing of
the JAX package. The tests hold the two copies bitwise equal on the same
inputs.

- 1D 3-point:  u'[i]     = (u[i-1] + u[i+1]) / 2
- 2D 5-point:  u'[i,j]   = (u[i-1,j] + u[i+1,j] + u[i,j-1] + u[i,j+1]) / 4
- 3D 7-point:  u'[i,j,k] = (sum of the 6 face neighbors) / 6
- 2D 9-point:  u'[i,j]   = (sum of the 8 box neighbors) / 8
- 3D 27-point: u'[i,j,k] = (sum of the 26 box neighbors) / 26

Star: neighbour pairs are summed axis by axis, then across axes, then
scaled by ``1 / (2 * ndim)`` in the field's dtype. Box: see
:func:`jacobi9_step` and :func:`jacobi27_step`. Every kernel of the port
reproduces these associations, so float32 comparisons are bitwise.

Boundary conditions: ``dirichlet`` holds the boundary cells at their
initial values; ``periodic`` wraps (``np.roll``).
"""

from __future__ import annotations

import numpy as np

BCS = ("dirichlet", "periodic")


def check_bc(bc: str) -> None:
    if bc not in BCS:
        raise ValueError(f"bc must be one of {BCS}, got {bc!r}")


def jacobi_step(u: np.ndarray, bc: str = "dirichlet") -> np.ndarray:
    """One Jacobi relaxation step for 1D/2D/3D ``u`` (dispatch on ndim)."""
    check_bc(bc)
    d = u.ndim
    if d not in (1, 2, 3):
        raise ValueError(f"u must be 1/2/3-D, got ndim={u.ndim}")
    inv = np.asarray(1.0 / (2 * d), dtype=u.dtype)
    if bc == "periodic":
        acc = np.zeros_like(u)
        for axis in range(d):
            acc += np.roll(u, +1, axis=axis) + np.roll(u, -1, axis=axis)
        return (acc * inv).astype(u.dtype)
    out = u.copy()
    interior = tuple(slice(1, -1) for _ in range(d))
    acc = np.zeros_like(u[interior])
    for axis in range(d):
        lo = tuple(
            slice(0, -2) if a == axis else slice(1, -1) for a in range(d)
        )
        hi = tuple(
            slice(2, None) if a == axis else slice(1, -1) for a in range(d)
        )
        acc += u[lo] + u[hi]
    out[interior] = (acc * inv).astype(u.dtype)
    return out


def jacobi_run(
    u0: np.ndarray, iters: int, bc: str = "dirichlet"
) -> np.ndarray:
    """Run ``iters`` Jacobi steps serially (ping-pong)."""
    u = np.array(u0, copy=True)
    for _ in range(iters):
        u = jacobi_step(u, bc=bc)
    return u


def jacobi9_step(u: np.ndarray, bc: str = "dirichlet") -> np.ndarray:
    """One 2D 9-point (box) step: mean of the 8 box neighbors.

    The association is the kernels': the diagonals are horizontal rolls
    of the row-shifted arrays, summed as ``((up+down)+(left+right)) +
    ((ul+dr)+(ur+dl))`` and scaled by the exact power of two 1/8, so
    float32 comparisons are bitwise. Under dirichlet the edge cells'
    wrapped updates are discarded by the frozen ring, so the roll form is
    exact for both boundary conditions.
    """
    check_bc(bc)
    if u.ndim != 2:
        raise ValueError(f"9-point stencil needs a 2D field, got {u.ndim}D")
    eighth = np.asarray(0.125, dtype=u.dtype)
    up = np.roll(u, 1, axis=0)
    down = np.roll(u, -1, axis=0)
    left, right = np.roll(u, 1, axis=1), np.roll(u, -1, axis=1)
    ul, ur = np.roll(up, 1, axis=1), np.roll(up, -1, axis=1)
    dl, dr = np.roll(down, 1, axis=1), np.roll(down, -1, axis=1)
    new = ((((up + down) + (left + right)) + ((ul + dr) + (ur + dl)))
           * eighth).astype(u.dtype)
    if bc == "periodic":
        return new
    out = new
    out[0, :], out[-1, :] = u[0, :], u[-1, :]
    out[:, 0], out[:, -1] = u[:, 0], u[:, -1]
    return out


def jacobi9_run(
    u0: np.ndarray, iters: int, bc: str = "dirichlet"
) -> np.ndarray:
    """Run ``iters`` 9-point steps serially (ping-pong)."""
    u = np.array(u0, copy=True)
    for _ in range(iters):
        u = jacobi9_step(u, bc=bc)
    return u


def jacobi27_step(u: np.ndarray, bc: str = "dirichlet") -> np.ndarray:
    """One 3D 27-point (box) step: mean of the 26 box neighbors.

    Per z-plane the 9-point box sum ``box8`` (same association as
    :func:`jacobi9_step`), accumulated as ``(full9(zm) + full9(zp)) +
    box8(u)`` with ``full9(p) = box8(p) + p`` and scaled by 1/26 rounded
    to the field's dtype: a single trailing multiply, so float32
    comparisons are bitwise. Under dirichlet the frozen shell discards
    the edge cells' wrapped updates.
    """
    check_bc(bc)
    if u.ndim != 3:
        raise ValueError(f"27-point stencil needs a 3D field, got {u.ndim}D")

    def box8(p):
        up = np.roll(p, 1, axis=1)
        down = np.roll(p, -1, axis=1)
        return (
            (up + down) + (np.roll(p, 1, axis=2) + np.roll(p, -1, axis=2))
        ) + (
            (np.roll(up, 1, axis=2) + np.roll(down, -1, axis=2))
            + (np.roll(up, -1, axis=2) + np.roll(down, 1, axis=2))
        )

    zm = np.roll(u, 1, axis=0)
    zp = np.roll(u, -1, axis=0)
    # box8 works inside each plane, so box8(zm) is box8(u) rolled along z:
    # the same values, for a third of the work
    b = box8(u)
    inv = np.asarray(1.0 / 26.0, dtype=u.dtype)
    new = (
        (((np.roll(b, 1, axis=0) + zm) + (np.roll(b, -1, axis=0) + zp)) + b)
        * inv
    ).astype(u.dtype)
    if bc == "periodic":
        return new
    out = new
    out[0, :, :], out[-1, :, :] = u[0, :, :], u[-1, :, :]
    out[:, 0, :], out[:, -1, :] = u[:, 0, :], u[:, -1, :]
    out[:, :, 0], out[:, :, -1] = u[:, :, 0], u[:, :, -1]
    return out


def jacobi27_run(
    u0: np.ndarray, iters: int, bc: str = "dirichlet"
) -> np.ndarray:
    """Run ``iters`` 27-point steps serially (ping-pong)."""
    u = np.array(u0, copy=True)
    for _ in range(iters):
        u = jacobi27_step(u, bc=bc)
    return u


#: the serial step and run of each stencil, by the driver's ``--points``
#: (0 = the star of the field's dimension)
GOLDEN_STEPS = {0: jacobi_step, 9: jacobi9_step, 27: jacobi27_step}
GOLDEN_RUNS = {0: jacobi_run, 9: jacobi9_run, 27: jacobi27_run}


def jacobi_run_to_convergence(
    u0: np.ndarray,
    tol: float,
    max_iters: int,
    check_every: int = 10,
    bc: str = "dirichlet",
    step=None,
) -> tuple[np.ndarray, int, float]:
    """Iterate until the per-step L2 residual drops to ``tol``.

    Runs ``check_every`` steps of ``step`` (default :func:`jacobi_step`;
    ``jacobi9_step`` or ``jacobi27_step`` for a box stencil), measures the
    L2 norm of the last step's change, and stops when it reaches ``tol``
    or after ``max_iters`` total steps. Returns ``(u, iters_run,
    residual)``. The step diff is taken in the field dtype, cast to
    float32, squared and summed in float32, as the device loop does.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if step is None:
        step = jacobi_step
    u = np.array(u0, copy=True)
    it = 0
    res = np.inf
    while it < max_iters and res > tol:
        for _ in range(check_every - 1):
            u = step(u, bc=bc)
        new = step(u, bc=bc)
        d = (new - u).astype(np.float32)
        res = float(np.sqrt(np.sum(d * d, dtype=np.float32)))
        u = new
        it += check_every
    return u, it, res


def residual(u: np.ndarray, bc: str = "dirichlet") -> float:
    """L2 norm of one step's change, in float64."""
    diff = jacobi_step(u, bc=bc).astype(np.float64) - u.astype(np.float64)
    return float(np.sqrt(np.sum(diff * diff)))


def init_field(
    shape: tuple[int, ...],
    dtype=np.float32,
    kind: str = "hot-boundary",
    seed: int = 0,
) -> np.ndarray:
    """Canonical initial conditions for the benchmarks.

    ``hot-boundary``: zero interior, 1.0 on all faces (the Laplace steady
    state is then 1.0 everywhere). ``random``: uniform [0, 1) from
    ``seed``.
    """
    if kind == "hot-boundary":
        u = np.zeros(shape, dtype=dtype)
        for axis in range(len(shape)):
            lo = tuple(
                0 if a == axis else slice(None) for a in range(len(shape))
            )
            hi = tuple(
                -1 if a == axis else slice(None) for a in range(len(shape))
            )
            u[lo] = 1.0
            u[hi] = 1.0
        return u
    if kind == "random":
        rng = np.random.default_rng(seed)
        return rng.random(shape, dtype=np.float64).astype(dtype)
    raise ValueError(f"unknown init kind {kind!r}")
