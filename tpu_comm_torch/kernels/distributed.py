"""Distributed Jacobi stepping: halo exchange + local stencil update
(port of ``tpu_comm/kernels/distributed.py``, star stencils).

Per iteration each rank packs its faces, posts the sends and receives,
updates its block, waits, and fixes the cells that needed a ghost. JAX
runs that as one ``shard_map`` program with a ``fori_loop``; PyTorch runs
eagerly, so here it is a Python loop on every rank over this rank's own
block, with ``lax.psum`` an ``all_reduce``.

Local-update arms (``IMPLS``; the JAX names in brackets):

- ``torch`` [lax] — the stencil on the ghost-padded block
  (``halo.pad_halo`` + :func:`stencil_from_padded`), all in plain
  PyTorch in the field's dtype. Any dimensionality.
- ``overlap`` [overlap] — the interior/boundary split: post the
  exchange, update the interior from the raw block while it is in
  flight, wait, recompute every face cell from the ghosts.
- ``block`` [pallas] — the same split with the whole-field kernel
  (``step_block``, ``csrc/jacobi_block.cu``) as the update: it runs the
  block-periodic step on the raw block, then the faces are recomputed.
- ``stream`` [pallas-stream] — the same with the chunked stream kernel
  (``step_stream``, ``csrc/jacobi_stream.cu``).

``pack="kernel"`` (3D mesh; overlap, block, stream) routes the exchange
through the face-pack kernel (``kernels/pack.py``) instead of slice
copies (``"fused"``).

Outside the kernels only face cells are touched. XLA fuses JAX's
``assemble_padded`` + ``_faces_from_padded`` + ``jnp.where`` freeze into
a few passes; op for op in eager PyTorch each would cost a pass over the
whole field. So :func:`faces_from_ghosts` computes each face from slices
of the block and the ghosts, and :func:`dirichlet_freeze` copies only the
faces on the global boundary (the rank's coordinate is a Python int, so
that is a branch, not a mask). The association is JAX's: per-axis
neighbour pairs, summed in axis order, times ``1/(2d)`` in the field's
dtype, so float32 stays bitwise. The steps write in place into their
output buffer.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_comm_torch.bench import JAX_STENCIL_IMPLS
from tpu_comm_torch.comm import halo
from tpu_comm_torch.domain import Decomposition
from tpu_comm_torch.kernels import stencil_module
from tpu_comm_torch.kernels.pack import PACK_IMPLS
from tpu_comm_torch.kernels.reference import check_bc
from tpu_comm_torch.topo import CartMesh

#: the port's local-update arms
IMPLS = ("torch", "overlap", "block", "stream")
#: options of the JAX ``make_local_step`` that wait for a later slice
UNPORTED_OPTIONS = ("halo_wire", "halo_parts", "halo_width", "t_steps",
                    "fuse_steps")


def _inv(nd: int, dtype: torch.dtype) -> float:
    """``1/(2d)`` rounded to the field's dtype (``jnp.asarray(1/(2d),
    dtype)``), as an exact Python float."""
    return float(torch.tensor(1.0 / (2 * nd), dtype=torch.float64).to(dtype))


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
    return torch.mul(acc, _inv(d, padded.dtype), out=out)


def ring_mask_padded(shape, cart: CartMesh, t: int = 0) -> torch.Tensor:
    """Boolean mask of the GLOBAL boundary ring inside a width-``t``
    ghost-padded block of ``shape`` on this rank: for a rank at the mesh
    edge along an axis, the plane at padded index ``t`` (low) or
    ``shape[a]-1-t`` (high), full width in every other axis."""
    mask = torch.zeros(tuple(shape), dtype=torch.bool)
    for a, (coord, npart) in enumerate(zip(cart.coords, cart.shape)):
        if coord == 0:
            mask.narrow(a, t, 1).fill_(True)
        if coord == npart - 1:
            mask.narrow(a, shape[a] - 1 - t, 1).fill_(True)
    return mask


def dirichlet_freeze(new: torch.Tensor, block: torch.Tensor,
                     cart: CartMesh) -> torch.Tensor:
    """Restore the GLOBAL boundary cells of ``new`` from ``block``, in
    place: ``torch.where(ring_mask_padded(new.shape, cart), block, new)``
    done as one face copy per face on the global boundary. Frozen cells
    never change, so copying from the current block keeps the initial
    boundary values."""
    for a, (coord, npart) in enumerate(zip(cart.coords, cart.shape)):
        n = new.shape[a]
        if coord == 0:
            new.narrow(a, 0, 1).copy_(block.narrow(a, 0, 1))
        if coord == npart - 1:
            new.narrow(a, n - 1, 1).copy_(block.narrow(a, n - 1, 1))
    return new


def faces_from_ghosts(new: torch.Tensor, block: torch.Tensor,
                      ghosts: halo.Ghosts, cart: CartMesh,
                      bc: str) -> torch.Tensor:
    """Overwrite every boundary-face cell of ``new``, in place, with the
    exact 2d+1-point update computed from ``block`` and its ghosts.

    The values are those of JAX's ``_faces_from_padded`` on
    ``assemble_padded(block, ghosts)``, but only face-sized tensors are
    made: along the face's own axis the neighbour pair is the ghost and
    the cell one in; along every other axis it comes from the face line
    with that axis' two ghost lines concatenated on. Pairs are summed in
    axis order. Under ``dirichlet`` a face on the global boundary is
    skipped: :func:`dirichlet_freeze` restores it next.
    """
    nd = new.dim()
    inv = _inv(nd, new.dtype)
    ghost = {axis: (lo, hi) for axis, lo, hi in ghosts}
    for axis in range(nd):
        n = block.shape[axis]
        lo_g, hi_g = ghost[axis]
        for lo_face in (True, False):
            edge = cart.coords[axis] == (
                0 if lo_face else cart.shape[axis] - 1
            )
            if bc == "dirichlet" and edge:
                continue
            idx = 0 if lo_face else n - 1
            face = block.narrow(axis, idx, 1)
            acc = None
            for other in range(nd):
                if other == axis:
                    if lo_face:
                        term = lo_g + (
                            block.narrow(axis, 1, 1) if n > 1 else hi_g
                        )
                    else:
                        term = (
                            block.narrow(axis, n - 2, 1) if n > 1 else lo_g
                        ) + hi_g
                else:
                    lo_o, hi_o = ghost[other]
                    line = torch.cat([
                        lo_o.narrow(axis, idx, 1), face,
                        hi_o.narrow(axis, idx, 1),
                    ], dim=other)
                    m = block.shape[other]
                    term = line.narrow(other, 0, m) + line.narrow(other, 2, m)
                acc = term if acc is None else acc + term
            torch.mul(acc, inv, out=new.narrow(axis, idx, 1))
    return new


def _interior_update(block: torch.Tensor,
                     out: torch.Tensor | None) -> torch.Tensor:
    """The ``overlap`` arm's interior pass: the update of cells
    ``[1:-1, ...]`` from the raw block alone, written into ``out``. Face
    cells are left for :func:`faces_from_ghosts` (an axis of size <= 2
    has no interior: every cell is a face cell then)."""
    new = torch.empty_like(block) if out is None else out
    if all(s > 2 for s in block.shape):
        center = new
        for a in range(block.dim()):
            center = center.narrow(a, 1, block.shape[a] - 2)
        stencil_from_padded(block, out=center)
    return new


def make_local_step(cart: CartMesh, bc: str, impl: str = "torch",
                    pack: str = "fused", **kwargs):
    """Build the per-iteration function ``local_step(block, out=None)``
    of this rank: one halo exchange plus one update of its block,
    returning the new block (``out`` when the arm writes in place). All
    ranks of the mesh call it together."""
    check_bc(bc)
    if bc == "periodic":
        for name in cart.axis_names:
            if not cart.is_periodic(name) and cart.axis_size(name) > 1:
                raise ValueError(
                    f"bc=periodic needs a periodic mesh axis {name!r} "
                    f"(construct the CartMesh with periodic=True)"
                )
    if impl in JAX_STENCIL_IMPLS:
        raise ValueError(
            f"impl {impl!r} is the JAX package's name; the port calls "
            f"this arm {JAX_STENCIL_IMPLS[impl]!r}"
        )
    if pack not in PACK_IMPLS:
        raise ValueError(f"unknown pack impl {pack!r} (fused|kernel)")
    if pack == "kernel":
        if len(cart.axis_names) != 3 or impl not in (
            "overlap", "block", "stream"
        ):
            raise ValueError(
                "pack='kernel' needs a 3D mesh and "
                "impl=overlap|block|stream"
            )
    stencil = kwargs.pop("stencil", "star")
    if stencil != "star":
        raise ValueError(
            f"stencil={stencil!r} is not yet ported; see ROADMAP.md"
        )
    for name in UNPORTED_OPTIONS:
        if kwargs.pop(name, None) is not None:
            raise ValueError(f"{name} is not yet ported; see ROADMAP.md")
    if kwargs:
        raise ValueError(f"unknown kwargs for impl={impl!r}: {sorted(kwargs)}")

    if impl == "torch":

        def local_step(block, out=None):
            new = stencil_from_padded(halo.pad_halo(block, cart))
            if bc == "dirichlet":
                dirichlet_freeze(new, block, cart)
            return new

        return local_step

    if pack == "kernel":
        def start_exchange(block):
            return halo.start_exchange_ghosts_3d_packed(block, cart, "kernel")
    else:
        def start_exchange(block):
            return halo.start_exchange_ghosts(block, cart)

    if impl == "overlap":
        update = _interior_update
    elif impl in ("block", "stream"):
        # the kernels compute the block-periodic step; the face recompute
        # below makes the seams exact, so no ghost enters a kernel and it
        # depends on the raw block only
        kernel = stencil_module(len(cart.axis_names)).STEPS[impl]

        def update(block, out):
            return kernel(block, bc="periodic", out=out)
    elif impl in ("partitioned", "multi", "pallas-wave"):
        raise ValueError(f"impl {impl!r} is not yet ported; see ROADMAP.md")
    else:
        raise ValueError(f"unknown distributed impl {impl!r}")

    def local_step(block, out=None):
        # the order of JAX's step: start the exchange, run the update
        # that needs no ghost while it is in flight (NCCL transfers run
        # on their own stream), wait, recompute the faces
        pending = start_exchange(block)
        new = update(block, out)
        ghosts = pending.wait()
        faces_from_ghosts(new, block, ghosts, cart, bc)
        if bc == "dirichlet":
            dirichlet_freeze(new, block, cart)
        return new

    return local_step


def _check_block(block: torch.Tensor, dec: Decomposition) -> None:
    if tuple(block.shape) != dec.local_shape:
        raise ValueError(
            f"block shape {tuple(block.shape)} != local shape "
            f"{dec.local_shape}"
        )


def run_distributed(block: torch.Tensor, dec: Decomposition, iters: int,
                    bc: str = "dirichlet", impl: str = "torch",
                    **kwargs) -> torch.Tensor:
    """Run ``iters`` distributed Jacobi steps on this rank's block of the
    decomposed field; returns the rank's new block. Ping-pong over two
    buffers allocated once per call; ``block`` itself is only read."""
    _check_block(block, dec)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    step = make_local_step(dec.cart, bc, impl, **kwargs)
    if iters == 0:
        return block.clone()
    bufs = (torch.empty_like(block), torch.empty_like(block))
    src = block
    for i in range(iters):
        src = step(src, out=bufs[i % 2])
    return src


def run_distributed_to_convergence(
    block: torch.Tensor, dec: Decomposition, tol: float, max_iters: int,
    check_every: int = 10, bc: str = "dirichlet", impl: str = "torch",
    **kwargs,
) -> tuple[torch.Tensor, int, float]:
    """Distributed convergence loop: rounds of ``check_every`` steps until
    the global per-step L2 residual reaches ``tol`` or ``max_iters``
    steps have run. The residual's square is summed locally in float32
    and ``all_reduce``d over the mesh, so every rank reads the same value
    and takes the same stopping decision. Returns ``(block, iters_run,
    residual)``."""
    _check_block(block, dec)
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    step = make_local_step(dec.cart, bc, impl, **kwargs)
    bufs = (torch.empty_like(block), torch.empty_like(block))
    src = block
    n = 0
    it = 0
    res = float("inf")
    while it < max_iters and res > tol:
        for _ in range(check_every - 1):
            src = step(src, out=bufs[n % 2])
            n += 1
        new = step(src, out=bufs[n % 2])
        n += 1
        d = (new - src).float()
        sq = torch.sum(d * d, dtype=torch.float32)
        if dist.is_initialized():  # a lone rank may run without a group
            dist.all_reduce(sq)
        res = float(torch.sqrt(sq))
        src = new
        it += check_every
    return (src if n else block.clone()), it, res
