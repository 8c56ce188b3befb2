"""Device selection and the Cartesian rank mesh (port of
``tpu_comm/topo.py`` ``get_devices``, ``factor_mesh``,
``planned_mesh_shape``, ``CartMesh`` and ``make_cart_mesh``).

The port runs on the card unless the caller asks for the CPU. Asking for
``cuda`` where there is none is an error, never a quiet run on the CPU.

JAX runs one process over N devices; PyTorch runs one process per rank
over ``torch.distributed``. So a :class:`CartMesh` here is the mesh shape
plus THIS rank's place in it: rank ``r`` sits at the row-major coordinate
of ``r`` in ``shape`` (the id order of the JAX package's cpu-sim meshes),
and ``lax.axis_index`` becomes ``coords``, a tuple of Python ints. A
mesh built without a shape consults the banked topo plan
(:func:`planned_mesh_shape`, ``comm/topoplan.py``) before it falls back
to :func:`factor_mesh`, and carries the answering plan's ``plan_id``.
"""

from __future__ import annotations

import math
import os
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


def planned_mesh_shape(
    n: int, ndims: int,
) -> tuple[tuple[int, ...] | None, str | None]:
    """The banked topo plan's mesh for ``(n, ndims)``: ``(shape,
    plan_id)`` where a plan answers, ``(None, None)`` otherwise.

    The ``TPU_COMM_TOPO_PLAN`` knob steers it: ``0``/``off``/``none``
    turns the lookup off, a path reads that artifact instead of the
    banked ``tpu_comm_torch/data/topo_plan.json``, unset or ``1`` reads
    the banked one. A plan whose mesh does not multiply out to ``n`` is
    ignored."""
    knob = os.environ.get("TPU_COMM_TOPO_PLAN", "").strip()
    if knob.lower() in ("0", "off", "none"):
        return None, None
    from tpu_comm_torch.comm import topoplan

    path = knob if knob not in ("", "1") else None
    entry = topoplan.lookup(n, ndims, path=path)
    if entry is None:
        return None, None
    shape = tuple(int(x) for x in entry.get("mesh", ()))
    if len(shape) != ndims or math.prod(shape) != n:
        return None, None
    return shape, entry.get("plan_id")


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
    #: id of the banked topo plan that chose ``shape``; None where the
    #: shape was given or came from :func:`factor_mesh`
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
    banked topo plan for the world answers (:func:`planned_mesh_shape`,
    which stamps ``plan_id``), else :func:`factor_mesh`. An explicit
    shape always wins over the plan, and must
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
    plan_id = None
    if shape is None:
        shape, plan_id = planned_mesh_shape(world, ndims)
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
        rank=rank, plan_id=plan_id,
    )
