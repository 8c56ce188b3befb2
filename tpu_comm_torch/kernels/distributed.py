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
- ``multi`` [multi] — communication-avoiding stepping: one chained
  exchange of width-``t_steps`` ghosts (``halo.pad_halo``), then
  ``t_steps`` updates of the padded block in plain PyTorch in the
  field's dtype (:func:`multi_local_step`); one call of the step
  advances ``t_steps`` iterations. JAX's arm has no Pallas kernel
  either: its in-block steps are lax-level, and so are these.
- ``wave`` [pallas-wave] — the ring-buffered wave kernels
  (``csrc/wave.cu``) as the update, every stencil, every bc (the wrap
  arrives through the ghosts). In 1D and 2D the exchanged ghosts feed
  the kernel (``step_wave_ghost``): it waits for the exchange, then
  computes every cell, so nothing is recomputed after it (JAX's 2D form
  recomputes its two seam columns outside the kernel; here the kernel
  takes the x ghosts too). In 3D the update is the wavefront at t = 1
  (``jacobi3d.step_multi``), and for the box stencils their wave kernels
  under dirichlet; both depend on the raw block only, so they run while
  the exchange is in flight, and the faces are recomputed as for
  ``block``. ``rows_per_chunk`` sets the 1D and 2D ring blocks.

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

``stencil="9pt"`` (2D mesh) and ``"27pt"`` (3D mesh) are the box
stencils, which read the corner and (3D) edge neighbours. Their ghosts
come from the chained exchange (``halo.start_exchange_transitive``: each
axis' slabs carry the earlier axes' ghosts), every arm as above; the
faces are recomputed by :func:`box_faces_from_ghosts` from 3-wide slabs
of the transitively padded block, and the ``block``/``stream`` arms run
the box kernels (``csrc/box.cu``). ``overlap`` computes the interior
while the first axis' transfers are in flight; the later axes wait on
it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_comm_torch.bench import JAX_STENCIL_IMPLS
from tpu_comm_torch.comm import halo
from tpu_comm_torch.domain import Decomposition
from tpu_comm_torch.kernels import BOX, kernels_for
from tpu_comm_torch.kernels.pack import PACK_IMPLS
from tpu_comm_torch.kernels.padded import (  # noqa: F401
    FROM_PADDED,
    rounded,
    stencil9_from_padded,
    stencil27_from_padded,
    stencil_from_padded,
)
from tpu_comm_torch.kernels.reference import check_bc
from tpu_comm_torch.kernels.tiling import check_t_steps
from tpu_comm_torch.topo import CartMesh

#: the port's local-update arms
IMPLS = ("torch", "overlap", "block", "stream", "multi", "wave")
#: options of the JAX ``make_local_step`` that wait for a later slice
UNPORTED_OPTIONS = ("halo_wire", "halo_parts", "halo_width", "fuse_steps")


def ring_planes(cart: CartMesh, shape, t: int = 0):
    """The (axis, index) planes of the GLOBAL boundary ring inside a
    width-``t`` ghost-padded block of ``shape`` on this rank: for a rank
    at the mesh edge along an axis, padded index ``t`` (low) or
    ``shape[a]-1-t`` (high)."""
    planes = []
    for a, (coord, npart) in enumerate(zip(cart.coords, cart.shape)):
        if coord == 0:
            planes.append((a, t))
        if coord == npart - 1:
            planes.append((a, shape[a] - 1 - t))
    return planes


def ring_mask_padded(shape, cart: CartMesh, t: int = 0) -> torch.Tensor:
    """Boolean mask of the GLOBAL boundary ring inside a width-``t``
    ghost-padded block of ``shape`` on this rank: for a rank at the mesh
    edge along an axis, the plane at padded index ``t`` (low) or
    ``shape[a]-1-t`` (high), full width in every other axis."""
    mask = torch.zeros(tuple(shape), dtype=torch.bool)
    for a, i in ring_planes(cart, shape, t):
        mask.narrow(a, i, 1).fill_(True)
    return mask


def dirichlet_freeze(new: torch.Tensor, block: torch.Tensor,
                     cart: CartMesh) -> torch.Tensor:
    """Restore the GLOBAL boundary cells of ``new`` from ``block``, in
    place: ``torch.where(ring_mask_padded(new.shape, cart), block, new)``
    done as one face copy per face on the global boundary. Frozen cells
    never change, so copying from the current block keeps the initial
    boundary values."""
    for a, i in ring_planes(cart, new.shape):
        new.narrow(a, i, 1).copy_(block.narrow(a, i, 1))
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
    inv = rounded(1.0 / (2 * nd), new.dtype)
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


def box_faces_from_ghosts(new: torch.Tensor, block: torch.Tensor,
                          ghosts: halo.Ghosts, cart: CartMesh, bc: str,
                          from_padded) -> torch.Tensor:
    """Overwrite every boundary-face cell of ``new``, in place, with the
    exact box-stencil update (``from_padded``) of a 3-wide slab of the
    block padded with its transitive ghosts (``halo.padded_slab``): the
    slab's middle along the face's axis is the face, and it is padded in
    full along the other axes, so its edge and corner cells come out
    right. The values are JAX's ``_box_faces_from_padded``; only
    face-sized tensors are made. Under ``dirichlet`` a face on the global
    boundary is skipped: :func:`dirichlet_freeze` restores it next.
    """
    for axis in range(new.dim()):
        n = block.shape[axis]
        for lo_face in (True, False):
            edge = cart.coords[axis] == (
                0 if lo_face else cart.shape[axis] - 1
            )
            if bc == "dirichlet" and edge:
                continue
            idx = 0 if lo_face else n - 1
            slab = halo.padded_slab(block, ghosts, axis, idx - 1, idx + 2)
            from_padded(slab, out=new.narrow(axis, idx, 1))
    return new


def _interior_update(block: torch.Tensor, out: torch.Tensor | None,
                     from_padded=stencil_from_padded) -> torch.Tensor:
    """The ``overlap`` arm's interior pass: the update of cells
    ``[1:-1, ...]`` from the raw block alone, written into ``out``. Face
    cells are left for the face recompute (an axis of size <= 2 has no
    interior: every cell is a face cell then)."""
    new = torch.empty_like(block) if out is None else out
    if all(s > 2 for s in block.shape):
        center = new
        for a in range(block.dim()):
            center = center.narrow(a, 1, block.shape[a] - 2)
        from_padded(block, out=center)
    return new


def multi_local_step(cart: CartMesh, bc: str, t: int, from_padded):
    """The ``multi`` step: ``local_step(block, out=None)`` advances the
    block ``t`` iterations behind ONE exchange of width-``t`` ghosts
    (JAX's ``_multi_local_step``, for the star and the box stencils).

    ``halo.pad_halo``'s chained exchange fills every corner and edge
    region the t-step cone reads. Each step updates the padded block's
    core from the last one (``from_padded``, in the field's dtype) into
    the other of two padded buffers and zeroes its outer one-cell rim,
    as JAX's ``jnp.pad(core, 1)``: the rim's junk moves in one cell a
    step and never reaches the centre. Under dirichlet the global ring
    planes (padded index ``t`` and ``shape - 1 - t`` on an edge rank) are
    restored every step from the first padded block, plane by plane
    (JAX's ``_ring_mask_padded`` where): a barrier for the open edge's
    junk too. Returns the centre.
    """
    check_t_steps(t)

    def local_step(block, out=None):
        if any(s < t for s in block.shape):
            raise ValueError(
                f"local block {tuple(block.shape)} smaller than halo width "
                f"t_steps={t}; use fewer devices or smaller t_steps"
            )
        p = halo.pad_halo(block, cart, width=t)
        planes = ring_planes(cart, p.shape, t) if bc == "dirichlet" else []
        # the ring's first values, kept before p is written over
        frozen = [(a, i, p.narrow(a, i, 1).clone()) for a, i in planes]
        bufs = (p, torch.empty_like(p))
        core = tuple(slice(1, -1) for _ in range(p.dim()))
        for k in range(t):
            src, dst = bufs[k % 2], bufs[(k + 1) % 2]
            from_padded(src, out=dst[core])
            for a in range(dst.dim()):
                dst.narrow(a, 0, 1).zero_()
                dst.narrow(a, dst.shape[a] - 1, 1).zero_()
            for a, i, plane in frozen:
                dst.narrow(a, i, 1).copy_(plane)
        center = bufs[t % 2][tuple(slice(t, -t) for _ in range(p.dim()))]
        return center.clone() if out is None else out.copy_(center)

    return local_step


def wave_ghost_local_step(cart: CartMesh, bc: str,
                          rows_per_chunk: int | None = None):
    """The 1D and 2D star's ``wave`` step: exchange every axis' ghosts,
    wait, then one launch of the ghost-fed wave kernel
    (``jacobi1d``/``jacobi2d.step_wave_ghost``) computes every cell of the
    block from the block and its ghosts, and the dirichlet freeze follows.
    The kernel consumes the ghosts, so it runs after the exchange (JAX's
    runs after its streamed axis' exchange; the port's kernel takes the
    x ghosts too, so no transfer overlaps it)."""
    family = kernels_for(len(cart.axis_names))

    def local_step(block, out=None):
        ghosts = halo.start_exchange_ghosts(block, cart).wait()
        lines = [g for _, lo, hi in ghosts for g in (lo, hi)]
        new = family.step_wave_ghost(block, *lines,
                                     rows_per_chunk=rows_per_chunk, out=out)
        if bc == "dirichlet":
            dirichlet_freeze(new, block, cart)
        return new

    return local_step


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
    if stencil not in FROM_PADDED:
        raise ValueError(f"unknown stencil {stencil!r} (star|9pt|27pt)")
    nd = len(cart.axis_names)
    points = 0
    if stencil in BOX:
        # the corner-ghost path: the box stencils read diagonal
        # neighbours, so their ghosts come from the chained exchange
        want_nd, points = BOX[stencil]
        if nd != want_nd:
            raise ValueError(
                f"stencil={stencil!r} needs a {want_nd}D mesh, got {nd}D"
            )
        if impl not in IMPLS:
            raise ValueError(
                f"stencil={stencil!r} supports impl="
                f"{'|'.join(repr(i) for i in IMPLS)}, got {impl!r}"
            )
        if pack != "fused":
            # the box path's ghosts come from the chained exchange, never
            # the face-pack kernel: accepting the flag would label rows as
            # a pack arm that never ran
            raise ValueError(
                f"pack={pack!r} does not apply to the box stencils "
                f"(stencil={stencil!r} exchanges via the transitive "
                "pad_halo chain)"
            )
    for name in UNPORTED_OPTIONS:
        if kwargs.pop(name, None) is not None:
            raise ValueError(f"{name} is not yet ported; see ROADMAP.md")
    t = kwargs.pop("t_steps", 8) if impl == "multi" else None
    rows = None
    if impl == "wave" and stencil not in BOX:
        rows = kwargs.pop("rows_per_chunk", None)
        if nd == 3 and rows is not None:
            raise ValueError(
                "rows_per_chunk does not apply to the 3D wave (the kernel "
                "streams single planes)"
            )
    if kwargs:
        where = f"stencil={stencil!r} " if stencil in BOX else ""
        raise ValueError(
            f"unknown kwargs for {where}impl={impl!r}: {sorted(kwargs)}")
    from_padded = FROM_PADDED[stencil]

    if impl == "multi":
        return multi_local_step(cart, bc, t, from_padded)

    if impl == "wave" and nd < 3 and stencil not in BOX:
        return wave_ghost_local_step(cart, bc, rows)

    if impl == "torch":

        def local_step(block, out=None):
            new = from_padded(halo.pad_halo(block, cart))
            if bc == "dirichlet":
                dirichlet_freeze(new, block, cart)
            return new

        return local_step

    if stencil in BOX:
        def start_exchange(block):
            return halo.start_exchange_transitive(block, cart)

        def faces(new, block, ghosts):
            box_faces_from_ghosts(new, block, ghosts, cart, bc, from_padded)
    else:
        if pack == "kernel":
            def start_exchange(block):
                return halo.start_exchange_ghosts_3d_packed(
                    block, cart, "kernel")
        else:
            def start_exchange(block):
                return halo.start_exchange_ghosts(block, cart)

        def faces(new, block, ghosts):
            faces_from_ghosts(new, block, ghosts, cart, bc)

    if impl == "overlap":
        def update(block, out):
            return _interior_update(block, out, from_padded)
    elif impl in ("block", "stream"):
        # the kernels compute the block-periodic step; the face recompute
        # below makes the seams exact, so no ghost enters a kernel and it
        # depends on the raw block only
        kernel = kernels_for(nd, points).STEPS[impl]

        def update(block, out):
            return kernel(block, bc="periodic", out=out)
    elif impl == "wave":
        # the 3D star's and the boxes' wave kernels freeze exactly the
        # block's face cells, which the face recompute then replaces: the
        # dirichlet step of the raw block, no ghost enters the kernel
        family = kernels_for(nd, points)
        if stencil in BOX:
            def update(block, out):
                return family.step_wave(block, "dirichlet", out=out)
        else:
            def update(block, out):
                return family.step_multi(block, "dirichlet", 1, out=out)
    elif impl == "partitioned":
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
        faces(new, block, ghosts)
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
    buffers allocated once per call; ``block`` itself is only read.
    ``impl="multi"`` advances ``t_steps`` iterations a step, so ``iters``
    must be a multiple of it."""
    _check_block(block, dec)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if impl == "multi":
        t = kwargs.get("t_steps", 8)
        check_t_steps(t)
        if iters % t != 0:
            raise ValueError(
                f"iters={iters} must be a multiple of t_steps={t} for "
                f"impl='multi'"
            )
        iters //= t
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
