"""Pure communication-pattern math (the port's own copy of what it needs
from ``tpu_comm/comm/patterns.py``; no torch, no JAX).

- :func:`shift_pairs` — the (src, dst) table of a +/-1 shift along one
  mesh axis, which ``topo.CartMesh.shift_perm`` hands to the halo
  exchange (JAX feeds the same table to ``lax.ppermute``).
- :func:`split_spans`, :func:`partition_axis` — the sub-slabs of a face
  that the partitioned exchange sends one by one.
- :func:`halo_bytes_per_iter_model` — the benchmark rows' traffic model.
- :data:`HALO_WIDTH_LADDER`, :func:`deep_halo_window_bytes_model`,
  :func:`deep_halo_redundant_cells`, :func:`deep_halo_model` — the
  pricing of the deep-halo window (``--halo-width``, ``halosweep``).
- :class:`Edge`, :func:`halo_edges`, :func:`deep_halo_edges`,
  :func:`wire_total`, :func:`ring_allgather_edges` — the explicit wire
  edges an exchange or a ring all-gather dispatches, which the topology
  planner (``comm/topoplan.py``) sums to score a mesh.

The tests hold every one equal to the JAX package's on a table of
shapes, meshes, widths and part counts.
"""

from __future__ import annotations

from dataclasses import dataclass


def shift_pairs(
    n: int, shift: int, periodic: bool,
) -> list[tuple[int, int]]:
    """(src, dst) index pairs moving data ``shift`` steps along one mesh
    axis of size ``n``.

    ``shift=+1`` sends each position's data to its higher-coordinate
    neighbour. Non-periodic axes omit the wrapping pair; the open edge
    then receives zeros, which halo code masks with the physical
    boundary condition. A periodic axis of size 1 gives ``[(0, 0)]``: the
    position receives its own opposite edge.
    """
    pairs = []
    for src in range(n):
        dst = src + shift
        if 0 <= dst < n:
            pairs.append((src, dst))
        elif periodic:
            pairs.append((src, dst % n))
    return pairs


def split_spans(n: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous ``[start, stop)`` spans covering ``0..n`` in ``parts``
    near-equal pieces (``numpy.array_split``'s rule: the first ``n %
    parts`` spans are one longer). More parts than cells gives one span a
    cell; ``n = 0`` gives the one span ``(0, 0)``."""
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
    parts = min(parts, n) if n else 1
    base, rem = divmod(n, parts)
    spans, start = [], 0
    for i in range(parts):
        stop = start + base + (1 if i < rem else 0)
        spans.append((start, stop))
        start = stop
    return spans


def partition_axis(shape: tuple[int, ...], array_axis: int) -> int | None:
    """The axis a face slab is split along: the largest OTHER axis (ties
    go to the lowest index). None for a 1D block, whose face has no
    extent to split."""
    others = [a for a in range(len(shape)) if a != array_axis]
    if not others:
        return None
    return max(others, key=lambda a: (shape[a], -a))


def halo_bytes_per_iter_model(
    local_shape: tuple[int, ...],
    mesh_shape: tuple[int, ...],
    itemsize: int,
    width: int = 1,
) -> int:
    """Bytes each rank SENDS per iteration: the periodic-torus send
    volume, both directions counted, axes with a single rank move
    nothing (a wrap onto the own rank crosses no link)."""
    total = 0
    for i, p in enumerate(mesh_shape):
        if p == 1:
            continue
        face = width * itemsize
        for j, s in enumerate(local_shape):
            if j != i:
                face *= s
        total += 2 * face  # one slab to each neighbour
    return total


#: the --halo-width values ``halosweep`` walks by default: powers of two,
#: so each divides a power-of-two --fuse-steps chain
HALO_WIDTH_LADDER = (1, 2, 4, 8)


def deep_halo_window_bytes_model(
    local_shape: tuple[int, ...],
    mesh_shape: tuple[int, ...],
    itemsize: int,
    width: int,
) -> int:
    """Bytes each rank SENDS per ``width``-step deep-halo window under the
    CHAINED width-k exchange (``halo.pad_halo``): axis i's slabs carry the
    ghosts of every axis exchanged before it. An axis of one rank grows
    the slab (its pad still happens) but sends nothing. Per iteration it
    is this divided by ``width``."""
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    total = 0
    shape = list(local_shape)
    for i, p in enumerate(mesh_shape):
        if p > 1:
            face = width * itemsize
            for j, s in enumerate(shape):
                if j != i:
                    face *= s
            total += 2 * face  # one slab to each neighbour
        shape[i] += 2 * width  # later axes' slabs carry this axis' pad
    return total


def deep_halo_redundant_cells(
    local_shape: tuple[int, ...], width: int,
) -> int:
    """Cell updates one ``width``-step window computes BEYOND ``width x
    prod(local_shape)``: step j updates ``prod(n_i + 2*(width - j))``
    cells, and all outside the block is recomputed ghost work. Width 1
    computes nothing twice."""
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    base = 1
    for s in local_shape:
        base *= s
    total = 0
    for j in range(1, width + 1):
        vol = 1
        for s in local_shape:
            vol *= s + 2 * (width - j)
        total += vol - base
    return total


def deep_halo_model(
    local_shape: tuple[int, ...],
    mesh_shape: tuple[int, ...],
    itemsize: int,
    width: int,
) -> dict:
    """The deep-halo pricing of one row: the window's wire bytes and
    messages, their per-iteration averages, and the redundant share of
    the window's cell updates (the inputs of ``halosweep``'s crossover
    fit)."""
    base = 1
    for s in local_shape:
        base *= s
    window_bytes = deep_halo_window_bytes_model(
        local_shape, mesh_shape, itemsize, width
    )
    redundant = deep_halo_redundant_cells(local_shape, width)
    # one transfer a direction per exchanging axis, once a window
    msgs = 2 * sum(1 for p in mesh_shape if p > 1)
    cells = width * base + redundant
    return {
        "halo_width": width,
        "window_wire_bytes_per_chip": window_bytes,
        "halo_bytes_per_chip_per_iter": window_bytes // width,
        "msgs_per_chip_per_window": msgs,
        "msgs_per_chip_per_iter": msgs / width,
        "compute_cells_per_window": cells,
        "redundant_cells_per_window": redundant,
        "redundant_compute_frac": redundant / cells if cells else 0.0,
    }


# ------------------------------------------------------ edge extraction

@dataclass(frozen=True)
class Edge:
    """One modelled wire transfer: flat rank ``src`` sends ``nbytes`` to
    ``dst``. ``axis``/``direction`` locate the shift it rides (mesh axis
    index; +1 = toward the higher coordinate); ``span`` is the sub-slab
    interval of a partitioned exchange (None for a whole face). A
    self-edge (``src == dst``, the periodic wrap of an axis of one rank)
    moves nothing over a link."""

    src: int
    dst: int
    nbytes: int
    axis: int
    direction: int
    span: tuple[int, int] | None = None

    @property
    def is_wire(self) -> bool:
        return self.src != self.dst


def _ranks(mesh_shape: tuple[int, ...]) -> int:
    out = 1
    for p in mesh_shape:
        out *= int(p)
    return out


def _coords(rank: int, mesh_shape: tuple[int, ...]) -> tuple[int, ...]:
    out = []
    for p in reversed(mesh_shape):
        out.append(rank % p)
        rank //= p
    return tuple(reversed(out))


def _rank(coords: tuple[int, ...], mesh_shape: tuple[int, ...]) -> int:
    r = 0
    for c, p in zip(coords, mesh_shape):
        r = r * p + c
    return r


def _other_combos(mesh_shape: tuple[int, ...], axis: int) -> tuple:
    """The other mesh axes and every combination of their coordinates
    (the rings a shift along ``axis`` runs over)."""
    other_axes = [a for a in range(len(mesh_shape)) if a != axis]
    combos = [()]
    for a in other_axes:
        combos = [c + (v,) for c in combos for v in range(mesh_shape[a])]
    return other_axes, combos


def _shift_ranks(mesh_shape, axis, direction, periodic):
    """Every (src_rank, dst_rank) pair of a ``direction`` shift along
    ``axis``, ranks row-major over ``mesh_shape``, in the order the edge
    models list them."""
    ndim = len(mesh_shape)
    other_axes, combos = _other_combos(mesh_shape, axis)
    for s_idx, d_idx in shift_pairs(mesh_shape[axis], direction, periodic):
        for combo in combos:
            sc, dc = [0] * ndim, [0] * ndim
            sc[axis], dc[axis] = s_idx, d_idx
            for a, v in zip(other_axes, combo):
                sc[a] = dc[a] = v
            yield _rank(tuple(sc), mesh_shape), _rank(tuple(dc), mesh_shape)


def halo_edges(
    local_shape: tuple[int, ...],
    mesh_shape: tuple[int, ...],
    periodic: bool,
    itemsize: int,
    width: int = 1,
    parts: int | None = None,
) -> list[Edge]:
    """The (src_rank -> dst_rank, bytes) edges one halo exchange
    dispatches: per mesh axis, the hi face rides the +1
    :func:`shift_pairs` table and the lo face the -1 table, for every
    combination of the other axes' coordinates. A partitioned exchange
    (``parts=K``) splits each face along :func:`partition_axis` into
    :func:`split_spans` sub-slabs, one edge a sub-slab a pair. Ranks are
    row-major over ``mesh_shape``."""
    if len(local_shape) != len(mesh_shape):
        raise ValueError(
            f"local shape {local_shape} and mesh {mesh_shape} must "
            "share one ndim"
        )
    edges: list[Edge] = []
    for axis in range(len(mesh_shape)):
        if local_shape[axis] < width:
            raise ValueError(
                f"local size {local_shape[axis]} along axis {axis} < "
                f"halo width {width}"
            )
        if parts is None:
            spans: list[tuple[int, int] | None] = [None]
            span_elems = {None: 1}
            split_ax = None
        else:
            split_ax = partition_axis(local_shape, axis)
            if split_ax is None:
                spans = [(0, 1)]
            else:
                spans = list(split_spans(local_shape[split_ax], parts))
            span_elems = {s: (s[1] - s[0]) for s in spans}
        # the face's volume: the array axis collapsed to ``width`` and a
        # partitioned face's split axis replaced by the span's extent
        base = width * itemsize
        for j, s in enumerate(local_shape):
            if j == axis or (split_ax is not None and j == split_ax):
                continue
            base *= s
        for direction in (+1, -1):
            for src, dst in _shift_ranks(mesh_shape, axis, direction,
                                         periodic):
                for span in spans:
                    edges.append(Edge(
                        src, dst, base * span_elems[span], axis,
                        direction, span,
                    ))
    return edges


def deep_halo_edges(
    local_shape: tuple[int, ...],
    mesh_shape: tuple[int, ...],
    periodic: bool,
    itemsize: int,
    width: int,
) -> list[Edge]:
    """The wire edges ONE deep-halo window dispatches: the chained
    width-k exchange, where axis i's slab spans ``local[j] + 2*width``
    along every earlier axis j (the padded block it slices its faces
    from). The pair tables are :func:`halo_edges`'; only the bytes an
    edge differ."""
    if len(local_shape) != len(mesh_shape):
        raise ValueError(
            f"local shape {local_shape} and mesh {mesh_shape} must "
            "share one ndim"
        )
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    ndim = len(mesh_shape)
    edges: list[Edge] = []
    grown = list(local_shape)
    for axis in range(ndim):
        if local_shape[axis] < width:
            raise ValueError(
                f"local size {local_shape[axis]} along axis {axis} < "
                f"halo width {width}"
            )
        face = width * itemsize
        for j in range(ndim):
            if j != axis:
                face *= grown[j]
        for direction in (+1, -1):
            for src, dst in _shift_ranks(mesh_shape, axis, direction,
                                         periodic):
                edges.append(Edge(src, dst, face, axis, direction))
        grown[axis] += 2 * width  # the pad later axes' slabs carry
    return edges


def wire_total(edges: list[Edge]) -> int:
    """The summed link bytes of an edge set (a self-edge crosses no
    link)."""
    return sum(e.nbytes for e in edges if e.is_wire)


def ring_allgather_edges(n_world: int, block_bytes: int) -> list[Edge]:
    """The ring all-gather's wire model (the reshard naive arm's
    ``wire_bytes_per_chip``): every rank forwards ``n_world - 1`` blocks
    to its ring successor, one edge a rank carrying the whole volume."""
    if n_world < 2:
        return []
    return [
        Edge(r, (r + 1) % n_world, (n_world - 1) * block_bytes,
             axis=0, direction=+1)
        for r in range(n_world)
    ]
