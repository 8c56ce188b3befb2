"""Distributed Jacobi stepping: halo exchange + local stencil update
(port of ``tpu_comm/kernels/distributed.py``, star stencils).

Per iteration each rank packs its faces, posts the sends and receives,
updates its block, waits, and fixes the cells that needed a ghost. JAX
runs that as one ``shard_map`` program with a ``fori_loop``, dispatched
once; here every rank steps its own block, with ``lax.psum`` an
``all_reduce``. On the card a run is replays of a CUDA graph of its
steps, exchanges included (:func:`run_distributed`, ``kernels/graphs.py``;
the convergence loop a graph a round); on the CPU a Python loop of eager
steps.

Local-update arms (``IMPLS``; the JAX names in brackets):

- ``torch`` [lax] — the stencil on the ghost-padded block
  (``halo.pad_halo`` + :func:`stencil_from_padded`), all in plain
  PyTorch in the field's dtype. Any dimensionality.
- ``overlap`` [overlap] — the interior/boundary split: post the
  exchange, update the interior from the raw block while it is in
  flight, wait, recompute every face cell from the ghosts.
- ``partitioned`` [partitioned] — ``overlap`` fed by the partitioned
  exchange (``halo.start_exchange_ghosts_partitioned``, ``halo_parts``
  sub-slabs a face, each its own transfer). Its values equal
  ``overlap``'s bitwise. JAX also writes each face once a sub-slab, to
  give XLA's scheduler finer handles inside a fused graph; an eager step
  gains nothing from that, so the port recomputes each face whole
  (:func:`faces_from_ghosts`), the same values.
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

``halo_wire`` sends every arm's ghosts narrowed (``halo``'s
``wire_dtype``); ``halo_width=K`` (``torch``/``overlap``, the star) runs
the deep-halo window instead of the arm's step
(:func:`make_deep_halo_window`): one chained width-K exchange, then K
exchange-free steps. :func:`run_distributed_fused` runs a chain of
``fuse_steps``-step dispatches; on the card each is a replay of one CUDA
graph, captured once, exchange included.

Every arm's step is capturable: it reads no device value on the host,
branches only on Python values (shapes, mesh coordinates), and its
exchange posts its NCCL transfers on the current stream and waits on
them there (``work.wait()`` records a stream wait under capture).

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
from tpu_comm_torch.kernels.graphs import Graph, graph_chunk
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
IMPLS = ("torch", "overlap", "partitioned", "block", "stream", "multi",
         "wave")
#: the arms of the box stencils (JAX has no partitioned box step)
BOX_IMPLS = tuple(i for i in IMPLS if i != "partitioned")
#: the arms the deep-halo window composes with (JAX's ``lax`` and
#: ``overlap``): the window's chained width-k exchange and shrinking
#: update REPLACE the arm's own step, so the window is the same under
#: both names, and at k = 1 it equals the ``torch`` arm bitwise
DEEP_HALO_IMPLS = ("torch", "overlap")


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


def multi_local_step(cart: CartMesh, bc: str, t: int, from_padded,
                     wire=None):
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
        p = halo.pad_halo(block, cart, width=t, wire_dtype=wire)
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
                          rows_per_chunk: int | None = None, wire=None):
    """The 1D and 2D star's ``wave`` step: exchange every axis' ghosts,
    wait, then one launch of the ghost-fed wave kernel
    (``jacobi1d``/``jacobi2d.step_wave_ghost``) computes every cell of the
    block from the block and its ghosts, and the dirichlet freeze follows.
    The kernel consumes the ghosts, so it runs after the exchange (JAX's
    runs after its streamed axis' exchange; the port's kernel takes the
    x ghosts too, so no transfer overlaps it)."""
    family = kernels_for(len(cart.axis_names))

    def local_step(block, out=None):
        ghosts = halo.start_exchange_ghosts(block, cart,
                                            wire_dtype=wire).wait()
        lines = [g for _, lo, hi in ghosts for g in (lo, hi)]
        new = family.step_wave_ghost(block, *lines,
                                     rows_per_chunk=rows_per_chunk, out=out)
        if bc == "dirichlet":
            dirichlet_freeze(new, block, cart)
        return new

    return local_step


def _check_mesh_bc(cart: CartMesh, bc: str) -> None:
    check_bc(bc)
    if bc == "periodic":
        for name in cart.axis_names:
            if not cart.is_periodic(name) and cart.axis_size(name) > 1:
                raise ValueError(
                    f"bc=periodic needs a periodic mesh axis {name!r} "
                    f"(construct the CartMesh with periodic=True)"
                )


def make_local_step(cart: CartMesh, bc: str, impl: str = "torch",
                    pack: str = "fused", **kwargs):
    """Build the per-iteration function ``local_step(block, out=None)``
    of this rank: one halo exchange plus one update of its block,
    returning the new block (``out`` when the arm writes in place). All
    ranks of the mesh call it together.

    ``halo_wire="bfloat16"|"float16"`` sends the ghosts narrowed and
    widens them on receipt (``halo``'s ``wire_dtype``), for every arm and
    pack; the update stays in the field's dtype. ``halo_parts=K`` is the
    ``partitioned`` arm's sub-slabs a face (default 2)."""
    _check_mesh_bc(cart, bc)
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
    wire = halo.wire_dtype_of(kwargs.pop("halo_wire", None))
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
        if impl not in BOX_IMPLS:
            raise ValueError(
                f"stencil={stencil!r} supports impl="
                f"{'|'.join(repr(i) for i in BOX_IMPLS)}, got {impl!r}"
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
    t = kwargs.pop("t_steps", 8) if impl == "multi" else None
    parts = None
    if impl == "partitioned":
        parts = kwargs.pop("halo_parts", 2)
        if not isinstance(parts, int) or parts < 1:
            raise ValueError(
                f"halo_parts must be a positive int, got {parts!r}"
            )
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
        return multi_local_step(cart, bc, t, from_padded, wire)

    if impl == "wave" and nd < 3 and stencil not in BOX:
        return wave_ghost_local_step(cart, bc, rows, wire)

    if impl == "torch":

        def local_step(block, out=None):
            new = from_padded(halo.pad_halo(block, cart, wire_dtype=wire))
            if bc == "dirichlet":
                dirichlet_freeze(new, block, cart)
            return new

        return local_step

    if stencil in BOX:
        def start_exchange(block):
            return halo.start_exchange_transitive(block, cart,
                                                  wire_dtype=wire)

        def faces(new, block, ghosts):
            box_faces_from_ghosts(new, block, ghosts, cart, bc, from_padded)
    else:
        if pack == "kernel":
            def start_exchange(block):
                return halo.start_exchange_ghosts_3d_packed(
                    block, cart, "kernel", wire_dtype=wire)
        elif impl == "partitioned":
            def start_exchange(block):
                return halo.start_exchange_ghosts_partitioned(
                    block, cart, parts, wire_dtype=wire)
        else:
            def start_exchange(block):
                return halo.start_exchange_ghosts(block, cart,
                                                  wire_dtype=wire)

        def faces(new, block, ghosts):
            faces_from_ghosts(new, block, ghosts, cart, bc)

    if impl in ("overlap", "partitioned"):
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


def make_deep_halo_window(cart: CartMesh, bc: str, halo_width: int,
                          wire=None):
    """The communication-avoiding k-step window (JAX's
    ``make_deep_halo_window``): ``window(block, out=None)`` exchanges
    width-``halo_width`` ghosts ONCE (``halo.pad_halo``'s chain fills
    every corner and edge region the k-step cone reads), then runs
    ``halo_width`` exchange-free steps of :func:`stencil_from_padded`,
    each shrinking the array by one cell a side, so that after k steps
    the block's shape is left. Every cell outside the block is redundant
    ghost recompute (``patterns.deep_halo_redundant_cells``). Under
    dirichlet the global ring plane, ``halo_width - j`` cells in after
    step j, is restored every step from the first padded field, face
    copy by face copy (:func:`ring_planes`, as :func:`dirichlet_freeze`;
    no mask is built, so the window can be captured in a CUDA graph):
    the barrier that also stops the open edge's junk. Float32 equals the
    per-step ``torch`` arm bitwise: the same expression on the same
    inputs."""
    _check_mesh_bc(cart, bc)
    if halo_width < 1:
        raise ValueError(f"halo_width must be >= 1, got {halo_width}")
    wire = halo.wire_dtype_of(wire)

    def window(block, out=None):
        p0 = halo.pad_halo(block, cart, width=halo_width, wire_dtype=wire)
        p = p0
        for j in range(1, halo_width + 1):
            # the last step has the block's shape: straight into out
            p = stencil_from_padded(p, out=out if j == halo_width else None)
            if bc == "dirichlet":
                # the ring planes of the shrunken array, from the first
                # padded field trimmed to its shape
                first = p0
                for a in range(p.dim()):
                    first = first.narrow(a, j, p.shape[a])
                for a, i in ring_planes(cart, p.shape, halo_width - j):
                    p.narrow(a, i, 1).copy_(first.narrow(a, i, 1))
        return p

    return window


def _step_and_trips(cart: CartMesh, bc: str, impl: str, opts: dict,
                    steps: int):
    """The step body of both runners: the arm's ``local_step`` looped
    ``steps`` times, or with ``halo_width`` in ``opts`` the deep-halo
    window looped ``steps / halo_width`` times (one chained exchange a
    window). Returns ``(step_fn, trips)``; every check is here, with
    JAX's messages."""
    hw = opts.pop("halo_width", None)
    if hw is None:
        return make_local_step(cart, bc, impl, **opts), steps
    if not isinstance(hw, int) or hw < 1:
        raise ValueError(f"halo_width must be a positive int, got {hw!r}")
    if impl not in DEEP_HALO_IMPLS:
        raise ValueError(
            f"halo_width applies to impl="
            f"{'/'.join(repr(i) for i in DEEP_HALO_IMPLS)} (the chained "
            f"deep-halo exchange; partitioned/kernel arms keep their "
            f"per-step exchange structure, impl='multi' has t_steps), "
            f"got {impl!r}"
        )
    if steps % hw != 0:
        raise ValueError(
            f"steps={steps} must be a multiple of halo_width={hw} "
            f"(each window advances halo_width exchange-free steps)"
        )
    wire = opts.pop("halo_wire", None)
    if opts:
        raise ValueError(
            f"unknown kwargs for the deep-halo window: {sorted(opts)}"
        )
    return make_deep_halo_window(cart, bc, hw, wire=wire), steps // hw


def _check_block(block: torch.Tensor, dec: Decomposition) -> None:
    if tuple(block.shape) != dec.local_shape:
        raise ValueError(
            f"block shape {tuple(block.shape)} != local shape "
            f"{dec.local_shape}"
        )


def _chain(step, x: torch.Tensor, y: torch.Tensor, trips: int
           ) -> torch.Tensor:
    """``trips`` calls of ``step`` from ``x``, ping-pong between ``y`` and
    ``x``, the result left in ``x`` (one copy when ``trips`` is odd or the
    step returns a buffer of its own)."""
    src = x
    for i in range(trips):
        src = step(src, out=(y, x)[i % 2])
    if src is not x:
        x.copy_(src)
    return x


def _run_plan(block: torch.Tensor, dec: Decomposition, iters: int, bc: str,
              impl: str, kwargs: dict):
    """The checks of :func:`run_distributed` and its ``(step, trips)``."""
    _check_block(block, dec)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if impl == "multi":
        if kwargs.get("halo_width") is not None:
            raise ValueError(
                "halo_width and impl='multi' are both "
                "communication-avoiding steppers; impl='multi' shapes "
                "its window with t_steps — pick one"
            )
        t = kwargs.get("t_steps", 8)
        check_t_steps(t)
        if iters % t != 0:
            raise ValueError(
                f"iters={iters} must be a multiple of t_steps={t} for "
                f"impl='multi'"
            )
        iters //= t
    return _step_and_trips(dec.cart, bc, impl, dict(kwargs), iters)


def _run_eager(step, block: torch.Tensor, trips: int) -> torch.Tensor:
    """``trips`` calls of ``step`` launched one by one from the host,
    ping-pong over two buffers allocated once; ``block`` is only read."""
    bufs = (torch.empty_like(block), torch.empty_like(block))
    src = block
    for i in range(trips):
        src = step(src, out=bufs[i % 2])
    return src


def run_distributed(block: torch.Tensor, dec: Decomposition, iters: int,
                    bc: str = "dirichlet", impl: str = "torch",
                    graphs: dict | None = None, **kwargs) -> torch.Tensor:
    """Run ``iters`` distributed Jacobi steps on this rank's block of the
    decomposed field; returns the rank's new block; ``block`` itself is
    only read. ``impl="multi"`` advances ``t_steps`` iterations a step, so
    ``iters`` must be a multiple of it; ``halo_width=K``
    (``torch``/``overlap``) runs ``iters / K`` deep-halo windows, so
    ``iters`` must be a multiple of K.

    On the card the run is JAX's one dispatch: its trips (steps,
    ``multi`` passes or windows) replay a :class:`GraphChain` of
    :func:`graphs.graph_chunk` trips, exchanges included, captured once
    (:func:`_replay`, whose ``graphs`` cache the caller keeps across
    calls). On the CPU the steps run eagerly, one call each, over two
    buffers; the result is the same."""
    step, trips = _run_plan(block, dec, iters, bc, impl, kwargs)
    if trips == 0:
        return block.clone()
    if block.device.type != "cuda":
        return _run_eager(step, block, trips)
    chunk = graph_chunk(trips)
    key = ("run", dec.cart, dec.global_shape, block.dtype, block.device,
           chunk, bc, impl, tuple(sorted(kwargs.items())))
    return _replay(graphs, key, lambda x, y: GraphChain(step, chunk, x, y),
                   block, trips // chunk)


def _run_distributed_eager(block: torch.Tensor, dec: Decomposition,
                           iters: int, bc: str = "dirichlet",
                           impl: str = "torch", **kwargs) -> torch.Tensor:
    """:func:`run_distributed` with every step launched from the host, on
    any device: the card's eager baseline, which the card check holds the
    graphed run against (bitwise) and times beside it."""
    step, trips = _run_plan(block, dec, iters, bc, impl, kwargs)
    if trips == 0:
        return block.clone()
    return _run_eager(step, block, trips)


class GraphChain(Graph):
    """A chain of ``trips`` calls of ``step`` as one :class:`Graph` over
    two static buffers: it reads the field from ``x`` and leaves the
    result in ``x`` (``y`` is the ping-pong partner). ``dispatch()`` runs
    the chain (eagerly the first time, a replay after)."""

    def __init__(self, step, trips: int, x: torch.Tensor, y: torch.Tensor,
                 debug: bool = False):
        self.step, self.trips, self.x, self.y = step, trips, x, y
        super().__init__(lambda: _chain(step, x, y, trips), debug=debug)


def buffers(graphs: dict, block: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two static field buffers of ``block``'s shape, dtype and device
    that every graph of ``graphs`` shares (one graph runs at a time, and
    each is seeded before it runs), made at first use."""
    key = ("buffers", tuple(block.shape), block.dtype, block.device)
    if key not in graphs:
        graphs[key] = (torch.empty_like(block), torch.empty_like(block))
    return graphs[key]


def _graph(graphs: dict, key, make, block: torch.Tensor) -> Graph:
    """The graph cached under ``key``, made by ``make(x, y)`` over the
    shared buffers (:func:`buffers`) at first use."""
    if key not in graphs:
        graphs[key] = make(*buffers(graphs, block))
    return graphs[key]


def _replay(graphs: dict | None, key, make, block: torch.Tensor,
            n: int) -> torch.Tensor:
    """``n`` dispatches of the chain cached under ``key`` (made by
    ``make(x, y)``) from ``block``, which is copied into the chain's
    buffer once (the seed copy); returns a copy of the result (the next
    call overwrites the buffer). ``graphs``, a dict the caller keeps for
    the life of its process group, holds the chains across calls; the
    caller frees them (:func:`release_graphs`) before the group is
    destroyed (a graph holds the communicator it captured). With
    ``graphs=None`` the chain is captured anew and freed on return, and
    a single dispatch runs eagerly: its capture would never replay."""
    if graphs is None:
        if n == 1:
            chain = make(torch.empty_like(block), torch.empty_like(block))
            chain.x.copy_(block)
            return chain.fn()
        graphs = {}
        try:
            return _replay(graphs, key, make, block, n)
        finally:
            release_graphs(graphs)
    chain = _graph(graphs, key, make, block)
    chain.x.copy_(block)
    for _ in range(n):
        chain.dispatch()
    return chain.x.clone()


def run_distributed_fused(
    block: torch.Tensor, dec: Decomposition, iters: int, fuse_steps: int,
    bc: str = "dirichlet", impl: str = "torch", graphs: dict | None = None,
    **kwargs,
) -> tuple[torch.Tensor, int]:
    """Advance ``iters`` distributed steps as a chain of ``iters /
    fuse_steps`` dispatches of ``fuse_steps`` steps each (JAX's
    ``run_distributed_fused``, with its checks and messages); returns
    ``(block, n_dispatches)``. ``fuse_steps=1`` is the per-step-dispatch
    baseline, ``fuse_steps=iters`` one dispatch. ``halo_width=K``
    composes: a dispatch runs ``fuse_steps / K`` windows.

    On the card a dispatch is one replay of a CUDA graph of the chain
    (:class:`GraphChain`), captured once per chain and cached in
    ``graphs`` as in :func:`run_distributed` (:func:`_replay`). On the
    CPU a dispatch is ``fuse_steps`` eager steps into two buffers; the
    result is the same. ``block`` is never written.
    """
    _check_block(block, dec)
    if fuse_steps < 1:
        raise ValueError(f"fuse_steps must be >= 1, got {fuse_steps}")
    if impl == "multi":
        raise ValueError(
            "impl='multi' already amortizes the exchange via t_steps; "
            "fuse_steps applies to the per-step impls "
            "(torch/overlap/partitioned/block/stream/wave)"
        )
    if iters % fuse_steps != 0:
        raise ValueError(
            f"iters={iters} must be a multiple of fuse_steps={fuse_steps}"
        )
    hw = kwargs.get("halo_width")
    if hw is not None:
        if not isinstance(hw, int) or hw < 1:
            raise ValueError(
                f"halo_width must be a positive int, got {hw!r}"
            )
        if hw > fuse_steps or fuse_steps % hw != 0:
            raise ValueError(
                f"halo_width={hw} does not tile the fuse_steps="
                f"{fuse_steps} dispatch into whole exchange-free "
                f"windows; pick halo_width <= fuse_steps with "
                f"fuse_steps % halo_width == 0"
            )
    n = iters // fuse_steps
    if block.device.type != "cuda":
        step, trips = _step_and_trips(dec.cart, bc, impl, dict(kwargs),
                                      fuse_steps)
        x, y = block.clone(), torch.empty_like(block)
        for _ in range(n):
            _chain(step, x, y, trips)
        return x, n
    key = ("fused", dec.cart, dec.global_shape, block.dtype, block.device,
           fuse_steps, bc, impl, tuple(sorted(kwargs.items())))
    step, trips = _step_and_trips(dec.cart, bc, impl, dict(kwargs),
                                  fuse_steps)
    return _replay(graphs, key, lambda x, y: GraphChain(step, trips, x, y),
                   block, n), n


def release_graphs(graphs: dict) -> None:
    """Free every graph of a runners' cache (the ``graphs`` dict of
    :func:`run_distributed`, :func:`run_distributed_fused` and
    :func:`run_distributed_to_convergence`) and its buffers."""
    for g in graphs.values():
        if isinstance(g, Graph):
            g.release()
    graphs.clear()


def _conv_checks(block: torch.Tensor, dec: Decomposition, check_every: int,
                 impl: str, kwargs: dict) -> None:
    _check_block(block, dec)
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if impl == "multi":
        raise ValueError(
            "convergence mode needs per-step residual granularity; use "
            "impl='torch'/'overlap' (not the fused 'multi' stepping)"
        )
    if kwargs.get("halo_width") is not None:
        raise ValueError(
            "convergence mode needs per-step residual granularity; "
            "drop halo_width (the deep-halo window advances "
            "halo_width steps per exchange)"
        )


def _residual(new: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The global per-step L2 residual as a device scalar: the square
    summed locally in float32, ``all_reduce``d over the mesh (every rank
    reads the same value), its root."""
    d = (new - src).float()
    sq = torch.sum(d * d, dtype=torch.float32)
    if dist.is_initialized():  # a lone rank may run without a group
        dist.all_reduce(sq)
    return torch.sqrt(sq)


class ConvergenceRound(Graph):
    """One round of the convergence loop, ``check_every`` steps and the
    residual of the last, as one :class:`Graph` over static buffers: it
    reads the field from ``x``, leaves the result in ``x`` and the
    residual in the device scalar ``res`` (``all_reduce`` included).
    ``dispatch()`` runs the round."""

    def __init__(self, step, check_every: int, x: torch.Tensor,
                 y: torch.Tensor):
        self.x, self.y = x, y
        self.res = torch.empty((), dtype=torch.float32, device=x.device)

        def round_():
            src = x
            for i in range(check_every - 1):
                src = step(src, out=(y, x)[i % 2])
            new = step(src, out=(y, x)[(check_every - 1) % 2])
            self.res.copy_(_residual(new, src))
            if new is not x:
                x.copy_(new)

        super().__init__(round_)


def run_distributed_to_convergence(
    block: torch.Tensor, dec: Decomposition, tol: float, max_iters: int,
    check_every: int = 10, bc: str = "dirichlet", impl: str = "torch",
    graphs: dict | None = None, **kwargs,
) -> tuple[torch.Tensor, int, float]:
    """Distributed convergence loop: rounds of ``check_every`` steps until
    the global per-step L2 residual reaches ``tol`` or ``max_iters``
    steps have run. The residual's square is summed locally in float32
    and ``all_reduce``d over the mesh, so every rank reads the same value
    and takes the same stopping decision. Returns ``(block, iters_run,
    residual)``.

    On the card a round is one replay of a :class:`ConvergenceRound`
    graph (JAX runs the loop as one ``lax.while_loop`` with the ``psum``
    inside); the host reads the residual once a round to decide. The
    rounds' values are the eager loop's. ``graphs`` as in
    :func:`run_distributed`."""
    _conv_checks(block, dec, check_every, impl, kwargs)
    if block.device.type != "cuda":
        return _convergence_eager(block, dec, tol, max_iters, check_every,
                                  bc, impl, **kwargs)
    key = ("conv", dec.cart, dec.global_shape, block.dtype, block.device,
           check_every, bc, impl, tuple(sorted(kwargs.items())))
    own = graphs is None
    graphs = {} if own else graphs
    try:
        rnd = _graph(graphs, key, lambda x, y: ConvergenceRound(
            make_local_step(dec.cart, bc, impl, **kwargs), check_every, x, y),
                     block)
        rnd.x.copy_(block)
        it = 0
        res = float("inf")
        while it < max_iters and res > tol:
            rnd.dispatch()
            res = float(rnd.res)
            it += check_every
        return (rnd.x.clone() if it else block.clone()), it, res
    finally:
        if own:
            release_graphs(graphs)


def _convergence_eager(
    block: torch.Tensor, dec: Decomposition, tol: float, max_iters: int,
    check_every: int = 10, bc: str = "dirichlet", impl: str = "torch",
    **kwargs,
) -> tuple[torch.Tensor, int, float]:
    """:func:`run_distributed_to_convergence` with every step launched
    from the host and the residual read each round, on any device (the
    CPU's path, and the card's eager baseline)."""
    _conv_checks(block, dec, check_every, impl, kwargs)
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
        res = float(_residual(new, src))
        src = new
        it += check_every
    return (src if n else block.clone()), it, res
