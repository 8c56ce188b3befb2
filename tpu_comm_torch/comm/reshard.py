"""Mesh->mesh array redistribution (resharding): plans and executors
(port of ``tpu_comm/comm/reshard.py``, same names in the same order).

Two executable arms per plan (PAPERS.md: arXiv:2112.01075):

- **naive**: all-gather, then re-slice: every rank gathers the whole
  global array, rebuilds it and slices out its destination block. One
  collective, the largest peak memory.
- **sequential**: the redistribution as at most ``n_world - 1`` chained
  point-to-point steps (ring distance k moves the src/dst overlap blocks
  between the rank pairs ``(s, s+k)``), each step bounded by the largest
  overlap slab. The global array is never built anywhere.

A :class:`ReshardPlan` is the static description both arms execute and
the placement-aware traffic model (PAPERS.md: arXiv:2005.09521):
``moved_bytes``, per-arm ``wire_bytes_per_chip`` and per-arm
``peak_live_bytes``. The plan math and the NumPy executor are the JAX
package's, copied (the port imports nothing of it); the tables are
equal for the same arguments (``tests/test_torch_reshard.py``).

Device identity across the two meshes is the flat rank, so a plan
between meshes of different sizes runs over the union world
``max(n_src, n_dst)``: ranks outside the source hold zeros, ranks
outside the destination produce output nobody reads.

JAX runs each arm inside ``shard_map`` over one mesh axis;
:func:`reshard_block` runs on this rank's block and is collective over
``group`` (every rank of it calls it), its transfers
``collectives.all_gather`` and ``collectives.ppermute``. Pure data
movement: every output is bitwise the source layout re-sliced, for any
dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from tpu_comm_torch.comm import collectives as coll

#: the two executable arms of every plan
ARMS = ("naive", "sequential")


def _prod(t) -> int:
    out = 1
    for v in t:
        out *= int(v)
    return out


def _unravel(rank: int, mesh: tuple[int, ...]) -> tuple[int, ...]:
    return tuple(int(c) for c in np.unravel_index(rank, mesh))


@dataclass(frozen=True)
class _Step:
    """One sequential-decomposition step: ring distance ``k`` moves the
    ``(s, (s+k) % n_world)`` overlap for every rank pair at once, padded
    to the step's largest overlap ``slab``. Tables are rank-indexed:
    ``send_start[s]`` is the sender-side slice origin for the pair
    ``(s, s+k)``; ``dst_start[d]``/``ext[d]`` the receiver-side
    placement for the pair ``(d-k, d)`` (zeros for empty pairs)."""

    k: int
    slab: tuple[int, ...]
    send_start: np.ndarray   # (n_world, ndim) int32
    dst_start: np.ndarray    # (n_world, ndim) int32
    ext: np.ndarray          # (n_world, ndim) int32


@dataclass(frozen=True)
class ReshardPlan:
    """Static mesh→mesh block-redistribution plan over one global array.

    ``src_mesh``/``dst_mesh`` are mesh factorizations of equal ndim
    (use size-1 axes for lower-dimensional meshes, e.g. ``(8, 1)`` for
    a 1D mesh over a 2D array); ``global_shape`` must be divisible by
    both factorizations along every axis (uniform blocks, the
    ``domain.Decomposition`` contract).
    """

    global_shape: tuple[int, ...]
    src_mesh: tuple[int, ...]
    dst_mesh: tuple[int, ...]
    itemsize: int

    def __post_init__(self):
        g, s, d = self.global_shape, self.src_mesh, self.dst_mesh
        if not (len(g) == len(s) == len(d)) or not g:
            raise ValueError(
                f"global shape {g}, src mesh {s} and dst mesh {d} must "
                "share one nonzero ndim (pad a 1D mesh with size-1 axes)"
            )
        for name, mesh in (("src", s), ("dst", d)):
            if any(m < 1 for m in mesh):
                raise ValueError(f"{name} mesh {mesh} has a < 1 axis")
            for a, (n, m) in enumerate(zip(g, mesh)):
                if n % m != 0:
                    raise ValueError(
                        f"global dim {n} (axis {a}) not divisible by "
                        f"{name} mesh axis size {m}"
                    )
        if self.itemsize < 1:
            raise ValueError(f"itemsize must be >= 1, got {self.itemsize}")

    # ------------------------------------------------------- geometry

    @property
    def ndim(self) -> int:
        return len(self.global_shape)

    @property
    def n_src(self) -> int:
        return _prod(self.src_mesh)

    @property
    def n_dst(self) -> int:
        return _prod(self.dst_mesh)

    @property
    def n_world(self) -> int:
        """The union world both arms execute over (flat rank identity)."""
        return max(self.n_src, self.n_dst)

    @property
    def src_local(self) -> tuple[int, ...]:
        return tuple(
            n // m for n, m in zip(self.global_shape, self.src_mesh)
        )

    @property
    def dst_local(self) -> tuple[int, ...]:
        return tuple(
            n // m for n, m in zip(self.global_shape, self.dst_mesh)
        )

    def _off(self, rank: int, mesh, local) -> tuple[int, ...]:
        return tuple(
            c * ln for c, ln in zip(_unravel(rank, mesh), local)
        )

    def _overlap(self, s: int, d: int):
        """``(lo_global, ext)`` of src rank ``s`` ∩ dst rank ``d``, or
        None when either rank is out of its mesh or the blocks are
        disjoint."""
        if s >= self.n_src or d >= self.n_dst:
            return None
        s_off = self._off(s, self.src_mesh, self.src_local)
        d_off = self._off(d, self.dst_mesh, self.dst_local)
        lo = tuple(max(a, b) for a, b in zip(s_off, d_off))
        hi = tuple(
            min(a + la, b + lb)
            for a, la, b, lb in zip(
                s_off, self.src_local, d_off, self.dst_local
            )
        )
        ext = tuple(h - lw for lw, h in zip(lo, hi))
        if any(e <= 0 for e in ext):
            return None
        return lo, ext

    # ---------------------------------------------- sequential steps

    @cached_property
    def steps(self) -> tuple[_Step, ...]:
        """The nonempty decomposition steps, k=0 (local copy) first."""
        n, nd = self.n_world, self.ndim
        out = []
        for k in range(n):
            send_start = np.zeros((n, nd), np.int32)
            dst_start = np.zeros((n, nd), np.int32)
            ext = np.zeros((n, nd), np.int32)
            for s in range(n):
                ov = self._overlap(s, (s + k) % n)
                if ov is not None:
                    s_off = self._off(s, self.src_mesh, self.src_local)
                    send_start[s] = [
                        lw - o for lw, o in zip(ov[0], s_off)
                    ]
            for d in range(n):
                ov = self._overlap((d - k) % n, d)
                if ov is not None:
                    d_off = self._off(d, self.dst_mesh, self.dst_local)
                    dst_start[d] = [
                        lw - o for lw, o in zip(ov[0], d_off)
                    ]
                    ext[d] = ov[1]
            slab = tuple(int(v) for v in ext.max(axis=0))
            if _prod(slab) == 0:
                continue  # no pair moves at this ring distance
            out.append(_Step(k, slab, send_start, dst_start, ext))
        return tuple(out)

    @cached_property
    def max_slab(self) -> tuple[int, ...]:
        """Componentwise max over every step's slab — the sequential
        arm's in-flight buffer bound."""
        if not self.steps:
            return (0,) * self.ndim
        return tuple(
            max(st.slab[i] for st in self.steps)
            for i in range(self.ndim)
        )

    @cached_property
    def src_pad(self) -> tuple[int, ...]:
        """Per-axis zero-padding the sender-side block needs so a
        slab-shaped slice never runs off the block (JAX's
        ``dynamic_slice`` would clamp): the worst slack
        ``start + slab - local`` over every step and rank (0 on axes
        whose slabs always fit — an unresharded axis pads nothing)."""
        pad = [0] * self.ndim
        for st in self.steps:
            for a in range(self.ndim):
                worst = int(st.send_start[:, a].max()) + st.slab[a] \
                    - self.src_local[a]
                pad[a] = max(pad[a], worst, 0)
        return tuple(pad)

    @cached_property
    def dst_pad(self) -> tuple[int, ...]:
        """Receiver-side analog of :attr:`src_pad` for the accumulator
        placements."""
        pad = [0] * self.ndim
        for st in self.steps:
            for a in range(self.ndim):
                worst = int(st.dst_start[:, a].max()) + st.slab[a] \
                    - self.dst_local[a]
                pad[a] = max(pad[a], worst, 0)
        return tuple(pad)

    # -------------------------------------------------- traffic model

    @cached_property
    def moved_bytes(self) -> int:
        """Placement-model lower bound: the payload bytes that truly
        change device (src∩dst overlaps between DIFFERENT flat ranks).
        Arm-independent — what any correct redistribution must move."""
        total = 0
        for st in self.steps:
            if st.k == 0:
                continue  # same flat rank: data stays put
            total += int(st.ext.prod(axis=1).sum())
        return total * self.itemsize

    def wire_bytes_per_chip(self, arm: str) -> int:
        """Modeled interconnect send bytes per device for one reshard."""
        if arm == "naive":
            # ring all-gather of every rank's (padded) source block
            return (self.n_world - 1) * _prod(self.src_local) \
                * self.itemsize
        if arm == "sequential":
            # one padded slab per wire step per rank
            return sum(
                _prod(st.slab) for st in self.steps if st.k
            ) * self.itemsize
        raise ValueError(f"unknown reshard arm {arm!r} (use {ARMS})")

    def peak_live_bytes(self, arm: str) -> int:
        """Modeled peak live bytes per device while the arm executes —
        the first-class metric next to GB/s (arXiv:2112.01075's axis).

        naive: input block + the gathered n_world-block stack + the
        reconstructed global array + the sliced destination block.
        sequential: input block + its slab-padded copy + the slab-padded
        destination accumulator + one in-flight send/recv slab pair.
        """
        src_vol, dst_vol = _prod(self.src_local), _prod(self.dst_local)
        if arm == "naive":
            elems = (
                src_vol + self.n_world * src_vol
                + _prod(self.global_shape) + dst_vol
            )
        elif arm == "sequential":
            elems = (
                src_vol
                + _prod(tuple(
                    a + b for a, b in zip(self.src_local, self.src_pad)
                ))
                + _prod(tuple(
                    a + b for a, b in zip(self.dst_local, self.dst_pad)
                ))
                + 2 * _prod(self.max_slab)
            )
        else:
            raise ValueError(f"unknown reshard arm {arm!r} (use {ARMS})")
        return elems * self.itemsize

    def n_steps(self, arm: str) -> int:
        """Collective steps the arm dispatches (naive: one all-gather;
        sequential: the nonempty decomposition steps)."""
        if arm == "naive":
            return 1
        if arm == "sequential":
            return len(self.steps)
        raise ValueError(f"unknown reshard arm {arm!r} (use {ARMS})")


def plan_reshard(
    global_shape, src_mesh, dst_mesh, itemsize: int,
) -> ReshardPlan:
    """Build (and validate) a mesh→mesh redistribution plan."""
    return ReshardPlan(
        tuple(int(x) for x in global_shape),
        tuple(int(x) for x in src_mesh),
        tuple(int(x) for x in dst_mesh),
        int(itemsize),
    )


# ------------------------------------------------------ NumPy executor

def _block_slices(rank: int, mesh, local) -> tuple[slice, ...]:
    coords = _unravel(rank, mesh)
    return tuple(
        slice(c * ln, (c + 1) * ln) for c, ln in zip(coords, local)
    )


def split_blocks(g: np.ndarray, mesh) -> list[np.ndarray]:
    """The per-flat-rank blocks of ``g`` under ``mesh`` (row-major rank
    order, copies — the reshard executors mutate nothing in place)."""
    mesh = tuple(mesh)
    local = tuple(n // m for n, m in zip(g.shape, mesh))
    return [
        np.ascontiguousarray(g[_block_slices(r, mesh, local)])
        for r in range(_prod(mesh))
    ]


def stack_blocks(g: np.ndarray, mesh, n_world: int) -> np.ndarray:
    """``(n_world, *local)`` stacked source blocks, zero-padded for
    union-world ranks outside the source mesh — the device arms' host
    input layout."""
    blocks = split_blocks(g, mesh)
    out = np.zeros((n_world,) + blocks[0].shape, g.dtype)
    for i, b in enumerate(blocks):
        out[i] = b
    return out


def assemble(blocks: list[np.ndarray], mesh, gshape) -> np.ndarray:
    """Inverse of :func:`split_blocks`."""
    mesh = tuple(mesh)
    local = tuple(n // m for n, m in zip(gshape, mesh))
    g = np.zeros(tuple(gshape), blocks[0].dtype)
    for r, b in enumerate(blocks):
        g[_block_slices(r, mesh, local)] = b
    return g


def oracle_blocks(g: np.ndarray, dst_mesh) -> list[np.ndarray]:
    """The direct re-slice ground truth every executor must match
    bitwise (redistribution is pure data movement)."""
    return split_blocks(g, dst_mesh)


def apply_plan_numpy(
    plan: ReshardPlan, src_blocks: list[np.ndarray],
) -> list[np.ndarray]:
    """Execute the sequential decomposition step-by-step in NumPy.

    An independent implementation of the same step tables the device
    arm runs (tests pin both against :func:`oracle_blocks`).
    """
    n = plan.n_world
    if len(src_blocks) < plan.n_src:
        raise ValueError(
            f"need {plan.n_src} source blocks, got {len(src_blocks)}"
        )
    dtype = src_blocks[0].dtype
    out = [
        np.zeros(plan.dst_local, dtype) for _ in range(plan.n_dst)
    ]
    for st in plan.steps:
        for d in range(min(n, plan.n_dst)):
            ext = st.ext[d]
            if not ext.all():
                continue
            s = (d - st.k) % n
            src_sl = tuple(
                slice(int(a), int(a + e))
                for a, e in zip(st.send_start[s], ext)
            )
            dst_sl = tuple(
                slice(int(a), int(a + e))
                for a, e in zip(st.dst_start[d], ext)
            )
            out[d][dst_sl] = src_blocks[s][src_sl]
    return out


# ------------------------------------------------------- device arms

def _interleave_perm(ndim: int) -> list[int]:
    """Transpose order turning ``(*mesh, *local)`` block stacks into
    the interleaved ``(m0, l0, m1, l1, ...)`` layout whose flat reshape
    is the global array."""
    return [x for i in range(ndim) for x in (i, ndim + i)]


def reshard_block(block: torch.Tensor, plan: ReshardPlan, arm: str,
                  group=None) -> torch.Tensor:
    """This rank's ``(*dst_local)`` block of the redistribution of the
    global array whose ``(*src_local)`` blocks the ranks hold (JAX's
    ``build_reshard_fn`` arm, one rank of it). Every rank of ``group``,
    which spans exactly ``plan.n_world`` ranks (the union world), calls
    it with its own block, zeros on a rank outside the source mesh; a
    rank outside the destination mesh gets a block nobody reads.
    ``block`` is only read, and the result never shares its memory."""
    if arm not in ARMS:
        raise ValueError(f"unknown reshard arm {arm!r} (use {ARMS})")
    n, rank = coll._size_rank(group)
    if n != plan.n_world:
        raise ValueError(
            f"the group spans {n} ranks, plan needs the union world "
            f"{plan.n_world}"
        )
    L_src, L_dst = plan.src_local, plan.dst_local
    if tuple(block.shape) != L_src:
        raise ValueError(
            f"block shape {tuple(block.shape)} != source block {L_src}"
        )
    ndim = plan.ndim
    if arm == "naive":
        gathered = coll.all_gather(block.reshape((1,) + L_src), group)
        g = (
            gathered[: plan.n_src]
            .reshape(plan.src_mesh + L_src)
            .permute(_interleave_perm(ndim))
            .reshape(plan.global_shape)
        )
        # JAX slices at offset 0 on a rank outside the destination mesh
        off = (plan._off(rank, plan.dst_mesh, L_dst) if rank < plan.n_dst
               else (0,) * ndim)
        mine = g[tuple(slice(o, o + ln) for o, ln in zip(off, L_dst))]
        # the gathered stack is this call's own, so a view of it may be
        # returned; a copy only where the slice is not contiguous
        return mine.contiguous()

    src_pad, dst_pad = plan.src_pad, plan.dst_pad
    src = block
    if any(src_pad):
        src = block.new_zeros(tuple(a + p for a, p in zip(L_src, src_pad)))
        src[tuple(slice(0, v) for v in L_src)] = block
    acc = block.new_zeros(tuple(a + p for a, p in zip(L_dst, dst_pad)))
    for st in plan.steps:
        ss = st.send_start[rank]
        slab = src[tuple(slice(int(a), int(a) + s)
                         for a, s in zip(ss, st.slab))]
        if st.k:
            slab = coll.ppermute(slab, coll.ring_perm(n, st.k), group)
        ext = st.ext[rank]
        if not ext.all():
            continue  # no pair lands on this rank at this distance
        # JAX writes the slab with dynamic_update_slice and keeps its
        # ext corner under a mask; the pads make sure no start clamps, so
        # assigning the ext corner is the same data movement
        ds = st.dst_start[rank]
        acc[tuple(slice(int(a), int(a + e)) for a, e in zip(ds, ext))] = \
            slab[tuple(slice(0, int(e)) for e in ext)]
    return acc[tuple(slice(0, v) for v in L_dst)].contiguous()
