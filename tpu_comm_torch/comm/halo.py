"""Ghost-cell halo exchange over the rank mesh (port of
``tpu_comm/comm/halo.py``).

Per step each rank packs its boundary faces into contiguous buffers,
posts a send and a receive for every neighbour, waits, and hands the
received ghosts to the local update. In the JAX package that is one
``lax.ppermute`` per direction per axis inside ``shard_map``; here it is
one ``torch.distributed.batch_isend_irecv`` over the same (src, dst)
table (``CartMesh.shift_perm``): NCCL for CUDA tensors, gloo for CPU
ones.

- pack    -> a contiguous copy of the boundary slab (or the face-pack
             kernel, ``kernels/pack.py``)
- Isend/Irecv -> every axis' four transfers posted in ONE batch, each
             send sliced from the raw block (:func:`start_exchange_ghosts`);
             or, for the box stencils' corner and edge ghosts, one batch
             per axis, each axis' sends grown by the earlier axes' ghosts
             (:func:`start_exchange_transitive`)
- Waitall -> ``PendingGhosts.wait``; work that needs only the raw block
             (the interior update) runs between the two
- unpack  -> the ghosts stay beside the block; :func:`pad_halo` and
             :func:`assemble_padded` concatenate them on where a padded
             block is wanted

Open (non-periodic) edges receive zeros, as ``ppermute`` delivers where
no pair sends; callers mask those cells with the boundary condition. A
neighbour that is the rank itself (a periodic axis of size 1) crosses no
link, as ``halo_bytes_per_iter`` counts it: under NCCL, which takes a
send and a receive to the own rank inside one batch (checked on an H100
at world size 1), it still goes through the same P2P calls, so that path
runs on a single card too; under gloo, which has no pair to itself, the
own opposite edge is the ghost.

``wire_dtype`` (every exchange function takes it; None = the field's
own dtype) sends the slabs narrowed, as JAX's ``_to_wire``: a send slab
is cast before it is posted, its receive buffer is in the wire dtype,
and the ghost is widened back to the block's dtype when it lands. The
chained exchange widens each axis' ghosts before the next axis grows its
slabs by them, so a corner crosses the wire, and is rounded, once a hop,
as JAX's ``pad_halo`` does. The gloo self-wrap rounds the same way.

:func:`start_exchange_ghosts_partitioned` (``--impl partitioned``) sends
each face as sub-slabs along its largest other axis
(``patterns.split_spans``), every sub-slab its own transfer, all in one
batch, and concatenates them back on arrival: the same ghosts.

Every function here is collective over the default process group: all
ranks of the mesh call it, with blocks of one shape.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_comm_torch.comm import patterns
from tpu_comm_torch.topo import CartMesh

Ghosts = list[tuple[int, torch.Tensor, torch.Tensor]]


def wire_dtype_of(wire_dtype) -> torch.dtype | None:
    """The torch dtype of a wire named by a string (``"bfloat16"``) or
    given as a dtype; None stays None."""
    if wire_dtype is None or isinstance(wire_dtype, torch.dtype):
        return wire_dtype
    wd = getattr(torch, str(wire_dtype), None)
    if not isinstance(wd, torch.dtype) or not wd.is_floating_point:
        raise ValueError(
            f"halo_wire must be a floating dtype, got {wire_dtype!r}"
        )
    return wd


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_wire(a: torch.Tensor, wire_dtype) -> torch.Tensor:
    """Narrow a send slab to the wire dtype, contiguous (None = the
    field's own dtype). The one shared guard of every exchange path: a
    wire at or above the field's width raises, since it would widen the
    transfer."""
    wd = wire_dtype_of(wire_dtype)
    if wd is None:
        return a
    if wd.itemsize >= a.dtype.itemsize:
        raise ValueError(
            f"halo wire dtype {_name(wd)} is not narrower than the field "
            f"dtype {_name(a.dtype)}; drop the wire_dtype"
        )
    return a.to(wd).contiguous()


class PendingGhosts:
    """An exchange in flight: ``wait()`` returns ``[(array_axis,
    lo_ghost, hi_ghost), ...]`` once every transfer has landed, each
    ghost widened to ``dtype`` (the block's; a no-op without a wire)."""

    def __init__(self, ghosts: Ghosts, works: list,
                 dtype: torch.dtype | None = None):
        self._ghosts = ghosts
        self._works = works
        self._dtype = dtype

    def wait(self) -> Ghosts:
        for work in self._works:
            work.wait()
        self._works = []
        if self._dtype is not None:
            self._ghosts = [(a, lo.to(self._dtype), hi.to(self._dtype))
                            for a, lo, hi in self._ghosts]
            self._dtype = None
        return self._ghosts


def _check_width(block: torch.Tensor, mesh_axis: str, array_axis: int,
                 width: int) -> None:
    n = block.shape[array_axis]
    if n < width:
        # name both sides of the pairing: on a multi-axis mesh the array
        # axis alone sends the reader to the wrong --mesh entry
        raise ValueError(
            f"local size {n} along array axis {array_axis} (exchanged "
            f"over mesh axis {mesh_axis!r}) < halo width {width}; use "
            f"fewer devices on that axis or a smaller width"
        )


def _post(cart: CartMesh,
          edges: list[tuple[str, int, torch.Tensor, torch.Tensor]],
          wire_dtype=None) -> PendingGhosts:
    """Post every transfer of ``edges`` = ``[(mesh_axis, array_axis,
    lo_edge, hi_edge), ...]`` (contiguous slabs of the block's dtype) in
    one batch, each slab narrowed to ``wire_dtype`` first.

    Per axis the order is: send the high edge up, receive the low ghost
    from below, send the low edge down, receive the high ghost from
    above. Every rank posts in this order, so on an axis of two ranks,
    where both neighbours are the same peer, the peer's first receive
    meets the first send (NCCL matches in order; gloo also by tag).
    """
    ops, ghosts = [], []
    self_p2p = dist.is_initialized() and dist.get_backend() == "nccl"
    dtype = edges[0][2].dtype if edges else None
    for i, (mesh_axis, array_axis, lo_edge, hi_edge) in enumerate(edges):
        up = cart.neighbor(mesh_axis, +1)
        down = cart.neighbor(mesh_axis, -1)
        lo_edge = _to_wire(lo_edge, wire_dtype)
        hi_edge = _to_wire(hi_edge, wire_dtype)
        if up == cart.rank and not self_p2p:
            # a periodic axis of one rank wraps onto itself: its own
            # opposite edge is the ghost (read-only, so no copy; a wire
            # rounds it, as the transfer would)
            ghosts.append((array_axis, hi_edge, lo_edge))
            continue
        lo_ghost = (torch.zeros_like(hi_edge) if down is None
                    else torch.empty_like(hi_edge))
        hi_ghost = (torch.zeros_like(lo_edge) if up is None
                    else torch.empty_like(lo_edge))
        if up is not None:
            ops.append(dist.P2POp(dist.isend, hi_edge, up, tag=2 * i))
        if down is not None:
            ops.append(dist.P2POp(dist.irecv, lo_ghost, down, tag=2 * i))
            ops.append(dist.P2POp(dist.isend, lo_edge, down, tag=2 * i + 1))
        if up is not None:
            ops.append(dist.P2POp(dist.irecv, hi_ghost, up, tag=2 * i + 1))
        ghosts.append((array_axis, lo_ghost, hi_ghost))
    works = dist.batch_isend_irecv(ops) if ops else []
    return PendingGhosts(ghosts, works,
                         dtype if wire_dtype is not None else None)


def _edges(block: torch.Tensor, array_axis: int, width: int):
    n = block.shape[array_axis]
    return (block.narrow(array_axis, 0, width).contiguous(),
            block.narrow(array_axis, n - width, width).contiguous())


def _grow(x: torch.Tensor, ghosts: dict, along: int, start: int,
          axes) -> torch.Tensor:
    """Grow ``x``, a slab along array axis ``along`` that starts at index
    ``start`` of the block (negative or past the end in a ghost), by the
    ghost lines of each axis in ``axes``, in that order. Axis k's ghosts
    (``ghosts[k] = (lo, hi)``) are padded along every axis before k, so
    ``x``'s lines in them start ``width`` further along ``along`` when
    ``along < k``."""
    length = x.shape[along]
    for k in axes:
        lo, hi = ghosts[k]
        i = start + lo.shape[k] if along < k else start
        x = torch.cat([lo.narrow(along, i, length), x,
                       hi.narrow(along, i, length)], dim=k)
    return x


def _post_along(block: torch.Tensor, cart: CartMesh, mesh_axis: str,
                array_axis: int, width: int, ghosts: dict,
                wire_dtype=None) -> PendingGhosts:
    """Post one axis' exchange: the block's two edge slabs along
    ``array_axis``, each grown by the ghost lines of the axes already in
    ``ghosts`` (none: the raw block's edges)."""
    n = block.shape[array_axis]
    lo, hi = (
        _grow(block.narrow(array_axis, start, width), ghosts, array_axis,
              start, sorted(ghosts)).contiguous()
        for start in (0, n - width)
    )
    return _post(cart, [(mesh_axis, array_axis, lo, hi)], wire_dtype)


def ghosts_along(
    block: torch.Tensor, cart: CartMesh, mesh_axis: str, array_axis: int,
    width: int = 1, wire_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exchange one axis' boundary slabs with both neighbours.

    Returns ``(lo_ghost, hi_ghost)``: the slabs received from the lower
    and upper neighbour along ``mesh_axis`` (shape = block with
    ``array_axis`` size replaced by ``width``). Zeros at open edges of a
    non-periodic axis.
    """
    _check_width(block, mesh_axis, array_axis, width)
    ((_, lo, hi),) = _post_along(block, cart, mesh_axis, array_axis, width,
                                 {}, wire_dtype).wait()
    return lo, hi


class PendingChain:
    """The transitive exchange in flight: the first axis' transfers are
    posted; ``wait()`` lands them, then posts and lands every later axis
    in turn, and returns ``[(array_axis, lo_ghost, hi_ghost), ...]``.

    Axis a's slabs carry the ghosts of axes 0..a-1 (a send of axis a is
    the block's edge grown by those ghost lines), so its ghosts are padded
    along every earlier axis: corners arrive after two hops, 3D corners
    after three. Only face-sized tensors are made.
    """

    def __init__(self, block: torch.Tensor, cart: CartMesh, width: int,
                 wire_dtype=None):
        for array_axis, mesh_axis in enumerate(cart.axis_names):
            _check_width(block, mesh_axis, array_axis, width)
        self._block, self._cart, self._width = block, cart, width
        self._wire = wire_dtype
        self._ghosts: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._pending = self._post_axis(0)

    def _post_axis(self, a: int) -> PendingGhosts:
        # the earlier axes' ghosts are widened already: a later slab that
        # carries them is narrowed again, as JAX's pad_halo chain does
        return _post_along(self._block, self._cart, self._cart.axis_names[a],
                           a, self._width, self._ghosts, self._wire)

    def wait(self) -> Ghosts:
        for a in range(len(self._cart.axis_names)):
            if a > 0:
                self._pending = self._post_axis(a)
            ((_, lo, hi),) = self._pending.wait()
            self._ghosts[a] = (lo, hi)
        return [(a, lo, hi) for a, (lo, hi) in sorted(self._ghosts.items())]


def start_exchange_transitive(block: torch.Tensor, cart: CartMesh,
                              width: int = 1,
                              wire_dtype=None) -> PendingChain:
    """Post the first axis of the chained (transitive) ghost exchange
    that the box stencils need: corner and edge ghosts included. Work
    that depends only on ``block`` can run until ``wait()``; the later
    axes wait on the earlier ones, so each is its own batch of
    transfers, in :func:`_post`'s order and tags."""
    return PendingChain(block, cart, width, wire_dtype)


def exchange_transitive(block: torch.Tensor, cart: CartMesh,
                        width: int = 1, wire_dtype=None) -> Ghosts:
    """:func:`start_exchange_transitive`, waited for."""
    return start_exchange_transitive(block, cart, width, wire_dtype).wait()


def padded_slab(block: torch.Tensor, ghosts: Ghosts, axis: int, start: int,
                stop: int) -> torch.Tensor:
    """Indices ``[start, stop)`` along ``axis`` of the block padded with
    its transitive ghosts (:func:`exchange_transitive`), every other axis
    padded in full: ``pad_halo(block)`` narrowed to those indices (shifted
    by the width), built from face-sized tensors only. Indices below 0
    come from the low ghost, at or past the block's end from the high
    one."""
    g = {a: (lo, hi) for a, lo, hi in ghosts}
    n = block.shape[axis]
    width = g[axis][0].shape[axis]
    later = range(axis + 1, block.dim())
    parts = []
    a, b = max(start, 0), min(stop, n)  # the part inside the block
    if start < 0:
        lo = g[axis][0].narrow(axis, width + start, min(stop, 0) - start)
        parts.append(_grow(lo, g, axis, start, later))
    if b > a:
        parts.append(_grow(block.narrow(axis, a, b - a), g, axis, a,
                           [k for k in range(block.dim()) if k != axis]))
    if stop > n:
        first = max(start, n)
        hi = g[axis][1].narrow(axis, first - n, stop - first)
        parts.append(_grow(hi, g, axis, first, later))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)


def pad_halo(block: torch.Tensor, cart: CartMesh,
             width: int = 1, wire_dtype=None) -> torch.Tensor:
    """Concatenate received ghosts onto every axis of ``block`` (array
    axis i is exchanged over ``cart.axis_names[i]``).

    The ghosts come from the chained exchange
    (:func:`exchange_transitive`): the second axis' slabs carry the first
    axis' ghosts, so corner ghosts arrive transitively. The result grows
    by ``2*width`` along each axis.
    """
    for array_axis, lo, hi in exchange_transitive(block, cart, width,
                                                  wire_dtype):
        block = torch.cat([lo, block, hi], dim=array_axis)
    return block


def start_exchange_ghosts(block: torch.Tensor, cart: CartMesh,
                          width: int = 1, wire_dtype=None) -> PendingGhosts:
    """Post every axis' ghost exchange FROM THE RAW BLOCK in one batch.

    Unlike :func:`pad_halo`, no transfer waits on another, and work that
    depends only on ``block`` can run until ``wait()``. Corner ghosts are
    NOT produced: enough for the 2d+1-point stencils.
    """
    for array_axis, mesh_axis in enumerate(cart.axis_names):
        _check_width(block, mesh_axis, array_axis, width)
    return _post(cart, [
        (mesh_axis, array_axis, *_edges(block, array_axis, width))
        for array_axis, mesh_axis in enumerate(cart.axis_names)
    ], wire_dtype)


def exchange_ghosts(block: torch.Tensor, cart: CartMesh,
                    width: int = 1, wire_dtype=None) -> Ghosts:
    """:func:`start_exchange_ghosts`, waited for: ``[(array_axis,
    lo_ghost, hi_ghost), ...]``."""
    return start_exchange_ghosts(block, cart, width, wire_dtype).wait()


class PendingParts:
    """The partitioned exchange in flight: ``wait()`` lands every
    sub-slab and returns each axis' ghosts reassembled along its split
    axis, ``[(array_axis, lo_ghost, hi_ghost), ...]``."""

    def __init__(self, pending: PendingGhosts,
                 layout: list[tuple[int, int | None, int]]):
        self._pending = pending
        self._layout = layout  # (array_axis, split_axis, parts) per axis

    def wait(self) -> Ghosts:
        subs = iter(self._pending.wait())
        out = []
        for array_axis, split_axis, parts in self._layout:
            got = [next(subs) for _ in range(parts)]
            if parts == 1:
                _, lo, hi = got[0]
            else:
                lo = torch.cat([g[1] for g in got], dim=split_axis)
                hi = torch.cat([g[2] for g in got], dim=split_axis)
            out.append((array_axis, lo, hi))
        return out


def start_exchange_ghosts_partitioned(
    block: torch.Tensor, cart: CartMesh, parts: int = 2, width: int = 1,
    wire_dtype=None,
) -> PendingParts:
    """The partitioned variant of :func:`start_exchange_ghosts` (JAX's
    ``exchange_ghosts_partitioned``): each face is split into ``parts``
    sub-slabs along its largest other axis (``patterns.partition_axis``,
    ``patterns.split_spans``: ragged spans allowed, at most one a cell),
    each sliced from the raw block and sent as its own transfer. Every
    transfer of every axis goes in ONE batch, each (axis, part,
    direction) with its own tag, posted by every rank in the same order.
    The ghosts come back reassembled, bitwise those of
    :func:`start_exchange_ghosts`; an open edge receives zeros a
    sub-slab. A 1D block has one part."""
    edges, layout = [], []
    for array_axis, mesh_axis in enumerate(cart.axis_names):
        _check_width(block, mesh_axis, array_axis, width)
        split_axis = patterns.partition_axis(tuple(block.shape), array_axis)
        spans = ([(0, 1)] if split_axis is None
                 else patterns.split_spans(block.shape[split_axis], parts))
        lo_edge, hi_edge = (block.narrow(array_axis, start, width)
                            for start in (0, block.shape[array_axis] - width))
        for start, stop in spans:
            if split_axis is None:
                lo, hi = lo_edge, hi_edge
            else:
                lo, hi = (e.narrow(split_axis, start, stop - start)
                          for e in (lo_edge, hi_edge))
            edges.append((mesh_axis, array_axis, lo.contiguous(),
                          hi.contiguous()))
        layout.append((array_axis, split_axis, len(spans)))
    return PendingParts(_post(cart, edges, wire_dtype), layout)


def exchange_ghosts_partitioned(
    block: torch.Tensor, cart: CartMesh, parts: int = 2, width: int = 1,
    wire_dtype=None,
) -> Ghosts:
    """:func:`start_exchange_ghosts_partitioned`, waited for."""
    return start_exchange_ghosts_partitioned(
        block, cart, parts, width, wire_dtype).wait()


def start_exchange_ghosts_3d_packed(
    block: torch.Tensor, cart: CartMesh, pack_impl: str = "kernel",
    wire_dtype=None,
) -> PendingGhosts:
    """Explicit-pack variant of :func:`start_exchange_ghosts` for 3D
    blocks: the six faces come from ``kernels.pack.pack_faces_3d`` (with
    ``pack_impl="kernel"``, one launch of the face-pack kernel for the
    four strided ones) and feed the same batch of transfers. Same
    contract: every send depends only on the raw block, no corner
    ghosts, zeros at open edges."""
    from tpu_comm_torch.kernels import pack as packmod

    if block.dim() != 3 or len(cart.axis_names) != 3:
        raise ValueError("exchange_ghosts_3d_packed needs a 3D block/mesh")
    faces = packmod.pack_faces_3d(block, impl=pack_impl)
    return _post(cart, [
        (
            cart.axis_names[a], a,
            faces[2 * a].unsqueeze(a).contiguous(),
            faces[2 * a + 1].unsqueeze(a).contiguous(),
        )
        for a in range(3)
    ], wire_dtype)


def exchange_ghosts_3d_packed(
    block: torch.Tensor, cart: CartMesh, pack_impl: str = "kernel",
    wire_dtype=None,
) -> Ghosts:
    """:func:`start_exchange_ghosts_3d_packed`, waited for."""
    return start_exchange_ghosts_3d_packed(block, cart, pack_impl,
                                           wire_dtype).wait()


def assemble_padded(block: torch.Tensor, ghosts: Ghosts) -> torch.Tensor:
    """Concatenate raw-block ghosts (:func:`exchange_ghosts`) into a
    padded block whose corner and edge regions are zero-filled.

    The zeros are sound for the face recompute of a 2d+1-point stencil: a
    face cell's neighbours are in the block or in a ghost slab, never in
    a corner of the padded array.
    """
    p = block
    done: dict[int, int] = {}  # array axis -> ghost width already padded on
    for array_axis, lo, hi in ghosts:
        width = lo.shape[array_axis]
        # F.pad lists the last axis first
        pad_cfg = [
            w for a in reversed(range(p.dim()))
            for w in (done.get(a, 0), done.get(a, 0))
        ]
        lo = F.pad(lo, pad_cfg)
        hi = F.pad(hi, pad_cfg)
        p = torch.cat([lo, p, hi], dim=array_axis)
        done[array_axis] = width
    return p


def halo_bytes_per_iter(
    local_shape: tuple[int, ...], cart: CartMesh, itemsize: int,
    width: int = 1,
) -> int:
    """Bytes each rank SENDS per iteration (both directions counted, axes
    with a single rank move nothing)."""
    return patterns.halo_bytes_per_iter_model(
        tuple(local_shape), tuple(cart.shape), itemsize, width,
    )


def deep_halo_window_bytes(
    local_shape: tuple[int, ...], cart: CartMesh, itemsize: int, width: int,
) -> int:
    """Bytes each rank SENDS per width-k deep-halo window: the CHAINED
    exchange (:func:`pad_halo`), whose later axes' slabs carry the earlier
    axes' ghosts (``patterns.deep_halo_window_bytes_model``)."""
    return patterns.deep_halo_window_bytes_model(
        tuple(local_shape), tuple(cart.shape), itemsize, width,
    )
