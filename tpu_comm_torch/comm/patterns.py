"""Pure communication-pattern math (the port's own copy of what it needs
from ``tpu_comm/comm/patterns.py``; no torch, no JAX).

- :func:`shift_pairs` — the (src, dst) table of a +/-1 shift along one
  mesh axis, which ``topo.CartMesh.shift_perm`` hands to the halo
  exchange (JAX feeds the same table to ``lax.ppermute``).
- :func:`halo_bytes_per_iter_model` — the benchmark rows' traffic model.

The tests hold both bitwise equal to the JAX package's on a table of
shapes.
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
