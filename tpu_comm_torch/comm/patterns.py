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

The tests hold every one equal to the JAX package's on a table of
shapes, meshes, widths and part counts.
"""

from __future__ import annotations


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
