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
             send sliced from the raw block (:func:`start_exchange_ghosts`)
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


class PendingGhosts:
    """An exchange in flight: ``wait()`` returns ``[(array_axis,
    lo_ghost, hi_ghost), ...]`` once every transfer has landed."""

    def __init__(self, ghosts: Ghosts, works: list):
        self._ghosts = ghosts
        self._works = works

    def wait(self) -> Ghosts:
        for work in self._works:
            work.wait()
        self._works = []
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
          ) -> PendingGhosts:
    """Post every transfer of ``edges`` = ``[(mesh_axis, array_axis,
    lo_edge, hi_edge), ...]`` (contiguous slabs) in one batch.

    Per axis the order is: send the high edge up, receive the low ghost
    from below, send the low edge down, receive the high ghost from
    above. Every rank posts in this order, so on an axis of two ranks,
    where both neighbours are the same peer, the peer's first receive
    meets the first send (NCCL matches in order; gloo also by tag).
    """
    ops, ghosts = [], []
    self_p2p = dist.is_initialized() and dist.get_backend() == "nccl"
    for i, (mesh_axis, array_axis, lo_edge, hi_edge) in enumerate(edges):
        up = cart.neighbor(mesh_axis, +1)
        down = cart.neighbor(mesh_axis, -1)
        if up == cart.rank and not self_p2p:
            # a periodic axis of one rank wraps onto itself: its own
            # opposite edge is the ghost (read-only, so no copy)
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
    return PendingGhosts(ghosts, works)


def _edges(block: torch.Tensor, array_axis: int, width: int):
    n = block.shape[array_axis]
    return (block.narrow(array_axis, 0, width).contiguous(),
            block.narrow(array_axis, n - width, width).contiguous())


def ghosts_along(
    block: torch.Tensor, cart: CartMesh, mesh_axis: str, array_axis: int,
    width: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exchange one axis' boundary slabs with both neighbours.

    Returns ``(lo_ghost, hi_ghost)``: the slabs received from the lower
    and upper neighbour along ``mesh_axis`` (shape = block with
    ``array_axis`` size replaced by ``width``). Zeros at open edges of a
    non-periodic axis.
    """
    _check_width(block, mesh_axis, array_axis, width)
    lo_edge, hi_edge = _edges(block, array_axis, width)
    ((_, lo, hi),) = _post(
        cart, [(mesh_axis, array_axis, lo_edge, hi_edge)]
    ).wait()
    return lo, hi


def pad_halo(block: torch.Tensor, cart: CartMesh,
             width: int = 1) -> torch.Tensor:
    """Concatenate received ghosts onto every axis of ``block`` (array
    axis i is exchanged over ``cart.axis_names[i]``).

    Axes are exchanged one after the other, each on the result of the
    one before, so the second axis' slabs carry the first axis' ghosts:
    corner ghosts arrive transitively. The result grows by ``2*width``
    along each axis.
    """
    for array_axis, mesh_axis in enumerate(cart.axis_names):
        lo, hi = ghosts_along(block, cart, mesh_axis, array_axis, width)
        block = torch.cat([lo, block, hi], dim=array_axis)
    return block


def start_exchange_ghosts(block: torch.Tensor, cart: CartMesh,
                          width: int = 1) -> PendingGhosts:
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
    ])


def exchange_ghosts(block: torch.Tensor, cart: CartMesh,
                    width: int = 1) -> Ghosts:
    """:func:`start_exchange_ghosts`, waited for: ``[(array_axis,
    lo_ghost, hi_ghost), ...]``."""
    return start_exchange_ghosts(block, cart, width).wait()


def start_exchange_ghosts_3d_packed(
    block: torch.Tensor, cart: CartMesh, pack_impl: str = "kernel",
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
    ])


def exchange_ghosts_3d_packed(
    block: torch.Tensor, cart: CartMesh, pack_impl: str = "kernel",
) -> Ghosts:
    """:func:`start_exchange_ghosts_3d_packed`, waited for."""
    return start_exchange_ghosts_3d_packed(block, cart, pack_impl).wait()


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
