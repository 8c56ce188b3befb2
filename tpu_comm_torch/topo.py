"""Device selection and the Cartesian rank mesh (port of
``tpu_comm/topo.py`` ``get_devices``, ``factor_mesh``, ``CartMesh`` and
``make_cart_mesh``).

The port runs on the card unless the caller asks for the CPU. Asking for
``cuda`` where there is none is an error, never a quiet run on the CPU.

JAX runs one process over N devices; PyTorch runs one process per rank
over ``torch.distributed``. So a :class:`CartMesh` here is the mesh shape
plus THIS rank's place in it: rank ``r`` sits at the row-major coordinate
of ``r`` in ``shape`` (the id order of the JAX package's cpu-sim meshes),
and ``lax.axis_index`` becomes ``coords``, a tuple of Python ints. The
banked topo plan is not consulted: ``plan_id`` is always None.
"""

from __future__ import annotations

import math
from collections.abc import Sequence
from dataclasses import dataclass

import torch

from tpu_comm_torch.comm.patterns import shift_pairs

BACKENDS = ("cuda", "cpu")


def get_device(backend: str = "cuda") -> torch.device:
    """The device for ``backend``: the current CUDA device, or the CPU."""
    if backend == "cpu":
        return torch.device("cpu")
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend=cuda requested but no CUDA device is available "
                "(torch.cuda.is_available() is False); pass --backend cpu "
                "to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def factor_mesh(n: int, ndims: int) -> tuple[int, ...]:
    """Near-square factorization of ``n`` into ``ndims`` factors
    (MPI_Dims_create): each step takes the largest divisor of the
    remainder not exceeding the balanced target, so the product is
    exactly ``n``; factors come out largest first."""
    dims = [1] * ndims
    remaining = n
    for i in range(ndims):
        target = max(round(remaining ** (1.0 / (ndims - i))), 1)
        best = 1
        f = 1
        while f * f <= remaining:
            if remaining % f == 0:
                for d in (f, remaining // f):
                    if best < d <= target:
                        best = d
            f += 1
        dims[i] = best
        remaining //= best
    return tuple(sorted(dims, reverse=True))


@dataclass(frozen=True)
class CartMesh:
    """A Cartesian rank mesh as one rank sees it: the analog of an MPI
    Cartesian communicator. :meth:`shift_perm` plays ``MPI_Cart_shift``
    for the whole axis (the table JAX gives ``lax.ppermute``),
    :meth:`neighbor` reads this rank's row of it."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    periodic: tuple[bool, ...] = ()
    rank: int = 0
    #: id of a banked topo plan; the port consults none
    plan_id: str | None = None

    def __post_init__(self):
        if not self.periodic:
            object.__setattr__(
                self, "periodic", (False,) * len(self.axis_names)
            )
        if len(self.periodic) != len(self.axis_names):
            raise ValueError("len(periodic) != len(axis_names)")
        if len(self.shape) != len(self.axis_names):
            raise ValueError("len(shape) != len(axis_names)")
        if not 0 <= self.rank < self.world:
            raise ValueError(
                f"rank {self.rank} outside mesh {self.shape} "
                f"({self.world} ranks)"
            )

    @property
    def world(self) -> int:
        return math.prod(self.shape)

    def coords_of(self, rank: int) -> tuple[int, ...]:
        """The mesh coordinate of ``rank`` (row-major in ``shape``)."""
        out = []
        for p in reversed(self.shape):
            out.append(rank % p)
            rank //= p
        return tuple(reversed(out))

    @property
    def coords(self) -> tuple[int, ...]:
        """This rank's mesh coordinate."""
        return self.coords_of(self.rank)

    def rank_at(self, coords: Sequence[int]) -> int:
        """The rank at mesh coordinate ``coords``."""
        r = 0
        for c, p in zip(coords, self.shape):
            r = r * p + c
        return r

    def _index(self, axis: str) -> int:
        return self.axis_names.index(axis)

    def axis_size(self, axis: str) -> int:
        return self.shape[self._index(axis)]

    def is_periodic(self, axis: str) -> bool:
        return self.periodic[self._index(axis)]

    def shift_perm(self, axis: str, shift: int) -> list[tuple[int, int]]:
        """(src, dst) coordinate pairs moving data ``shift`` steps along
        ``axis``; a non-periodic axis omits the wrapping pair."""
        return shift_pairs(
            self.axis_size(axis), shift, self.is_periodic(axis)
        )

    def neighbor(self, axis: str, shift: int) -> int | None:
        """The rank ``shift`` steps along ``axis`` from this one (the rank
        this one sends to under ``shift_perm(axis, shift)``), or None at
        an open edge. On a periodic axis of size 1 it is this rank."""
        i = self._index(axis)
        coords = list(self.coords)
        for src, dst in self.shift_perm(axis, shift):
            if src == coords[i]:
                coords[i] = dst
                return self.rank_at(coords)
        return None


def make_cart_mesh(
    ndims: int,
    shape: Sequence[int] | None = None,
    periodic: Sequence[bool] | bool = False,
    world: int | None = None,
    rank: int | None = None,
) -> CartMesh:
    """Build this rank's 1/2/3-D Cartesian mesh (``MPI_Dims_create`` +
    ``MPI_Cart_create``). ``world`` and ``rank`` default to the default
    process group's (1 and 0 where none is up); without ``shape`` the
    world is factored by :func:`factor_mesh`. An explicit shape must
    multiply out to the world size exactly: a mesh that left ranks out
    would hang their collectives."""
    import torch.distributed as dist

    if ndims not in (1, 2, 3):
        raise ValueError(f"ndims must be 1, 2 or 3, got {ndims}")
    axis_names = ("x", "y", "z")[:ndims]
    up = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if up else 1
    if rank is None:
        rank = dist.get_rank() if up else 0
    if shape is None:
        shape = factor_mesh(world, ndims)
    else:
        shape = tuple(int(s) for s in shape)
        if len(shape) != ndims:
            raise ValueError(
                f"mesh shape {shape} has {len(shape)} axes, the grid {ndims}"
            )
        if min(shape) < 1:
            raise ValueError(f"mesh shape {shape} needs positive sizes")
        if math.prod(shape) != world:
            raise RuntimeError(
                f"{world} ranks given, mesh shape {shape} needs exactly "
                f"{math.prod(shape)}"
            )
    if isinstance(periodic, bool):
        periodic = (periodic,) * ndims
    periodic = tuple(periodic)
    if len(periodic) != ndims:
        raise ValueError("len(periodic) != ndims")
    return CartMesh(
        shape=tuple(shape), axis_names=axis_names, periodic=periodic,
        rank=rank,
    )
