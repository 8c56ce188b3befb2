"""The stencils in plain PyTorch in the field's dtype: the arithmetic of
JAX's ``lax`` arms.

Each update is computed from a block padded by one cell a side, with the
golden's association: per-axis neighbour pairs summed in axis order (the
box stencils: ``reference.jacobi9_step``'s and ``jacobi27_step``'s),
times ``1/(2d)``, 1/8 or 1/26 rounded to the field's dtype, every add
rounded to that dtype as JAX's ``step_lax`` rounds it. The distributed
``torch`` and ``multi`` arms (``kernels/distributed.py``) pad with the
exchanged ghosts; the single-device ``torch`` arm (:func:`step_torch`)
pads with the field's own opposite faces, which is ``jnp.roll``'s wrap.
"""

from __future__ import annotations

import torch

from tpu_comm_torch.kernels.reference import check_bc


def rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to the field's dtype (``jnp.asarray(x, dtype)``), as
    an exact Python float: the stencils' ``1/(2d)``, 1/8 and 1/26."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def stencil_from_padded(padded: torch.Tensor,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """2d-point Jacobi update of the interior of a 1-cell-padded block.

    ``padded`` has every axis grown by 2; the result (written into
    ``out`` when given) has the original block shape: the mean of the 2d
    face neighbours, pairs summed axis by axis in the field's dtype.
    """
    d = padded.dim()
    acc = None
    for axis in range(d):
        inner = padded
        for a in range(d):
            if a != axis:
                inner = inner.narrow(a, 1, padded.shape[a] - 2)
        n = padded.shape[axis] - 2
        term = inner.narrow(axis, 0, n) + inner.narrow(axis, 2, n)
        acc = term if acc is None else acc + term
    return torch.mul(acc, rounded(1.0 / (2 * d), padded.dtype), out=out)


def stencil9_from_padded(padded: torch.Tensor,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """9-point (box) update of the interior of a 1-cell-padded 2D block,
    in the field's dtype (written into ``out`` when given).

    The diagonal slices reach the padded array's corners, which hold the
    neighbours' data only when the ghosts came from the chained exchange.
    The association is ``reference.jacobi9_step``'s.
    """
    if padded.dim() != 2:
        raise ValueError(
            f"9-point stencil needs a 2D block, got {padded.dim()}D"
        )
    up, down = padded[:-2, 1:-1], padded[2:, 1:-1]
    left, right = padded[1:-1, :-2], padded[1:-1, 2:]
    ul, ur = padded[:-2, :-2], padded[:-2, 2:]
    dl, dr = padded[2:, :-2], padded[2:, 2:]
    return torch.mul(
        ((up + down) + (left + right)) + ((ul + dr) + (ur + dl)), 0.125,
        out=out,
    )


def stencil27_from_padded(padded: torch.Tensor,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """27-point (box) update of the interior of a 1-cell-padded 3D block,
    in the field's dtype with 1/26 rounded to it (written into ``out``
    when given).

    The diagonal slices reach the padded array's edges (two chained
    exchanges) and corners (three). The association is
    ``reference.jacobi27_step``'s.
    """
    if padded.dim() != 3:
        raise ValueError(
            f"27-point stencil needs a 3D block, got {padded.dim()}D"
        )
    nz, ny, nx = (s - 2 for s in padded.shape)

    def sh(dz, dy, dx):
        return padded[1 + dz:1 + dz + nz, 1 + dy:1 + dy + ny,
                      1 + dx:1 + dx + nx]

    def box8(dz):
        return (
            (sh(dz, -1, 0) + sh(dz, 1, 0)) + (sh(dz, 0, -1) + sh(dz, 0, 1))
        ) + (
            (sh(dz, -1, -1) + sh(dz, 1, 1)) + (sh(dz, -1, 1) + sh(dz, 1, -1))
        )

    return torch.mul(
        ((box8(-1) + sh(-1, 0, 0)) + (box8(1) + sh(1, 0, 0))) + box8(0),
        rounded(1.0 / 26.0, padded.dtype), out=out,
    )


FROM_PADDED = {"star": stencil_from_padded, "9pt": stencil9_from_padded,
               "27pt": stencil27_from_padded}


def wrap_pad(u: torch.Tensor) -> torch.Tensor:
    """``u`` grown by one cell a side along every axis, each new face a
    copy of the opposite face (the periodic neighbours)."""
    p = u
    for a in range(u.dim()):
        n = p.shape[a]
        p = torch.cat([p.narrow(a, n - 1, 1), p, p.narrow(a, 0, 1)], dim=a)
    return p


def step_torch(u: torch.Tensor, bc: str, stencil: str,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One step of ``stencil`` (``FROM_PADDED``'s key) in plain PyTorch in
    the field's dtype, into ``out`` when given (which must not alias
    ``u``): the port of JAX's ``step_lax``. Under dirichlet the boundary
    ring keeps ``u``'s values."""
    check_bc(bc)
    new = FROM_PADDED[stencil](wrap_pad(u), out=out)
    if bc == "dirichlet":
        for a in range(u.dim()):
            for i in (0, u.shape[a] - 1):
                new.narrow(a, i, 1).copy_(u.narrow(a, i, 1))
    return new
