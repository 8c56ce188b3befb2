"""Collectives over ``torch.distributed`` (port of
``tpu_comm/comm/collectives.py``, same names in the same order).

Two arms per collective, as in the JAX package:

- **native**: one library collective (``all_reduce``,
  ``reduce_scatter_tensor``, ``all_gather_into_tensor``); NCCL on the
  card, gloo on the CPU, picks the algorithm and the sum order;
- **explicit**: the classical algorithm spelled out as point-to-point
  rounds (ring reduce-scatter / all-gather / allreduce, binomial-tree
  broadcast), each round one ``batch_isend_irecv`` (:func:`ppermute`),
  the only way to set the wire dtype a hop.

JAX runs these inside ``shard_map`` over one mesh axis; here every
function acts on this rank's tensor and is collective over ``group``
(default: the default process group): every rank of it calls it with a
tensor of the same shape and dtype. ``lax.axis_size`` and
``lax.axis_index`` become ``dist.get_world_size(group)`` and
``dist.get_rank(group)``. No function writes into its input (but
``allreduce(inplace=True)``); the root of a broadcast and a world of one
may get it back.

The explicit arm, ``bcast_psum`` and ``all_gather`` follow JAX's element
order and rounding: the ring fixes each chunk's sum order, a masked sum
adds only zeros, the rest only move data. So on the same input they
equal the JAX package's output bitwise (``tests/test_torch_collectives.py``).
``allreduce``, ``reduce_scatter`` and ``allreduce_mixed`` leave the sum
order to the library.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def ring_perm(n: int, step: int = 1) -> list[tuple[int, int]]:
    """src->dst pairs sending each shard's data ``step`` positions around
    the ring (default +1 = up; -1 = down, the ring-attention rotation)."""
    return [(i, (i + step) % n) for i in range(n)]


def _size_rank(group) -> tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def ppermute_start(xs, perm, group=None):
    """Post ``lax.ppermute`` of every tensor of ``xs`` along every (src,
    dst) pair of ``perm`` (group ranks) in one ``batch_isend_irecv``;
    returns ``(outs, works)``: what this rank receives of each tensor
    (zeros where no pair sends to it), filled once every work of
    ``works`` is waited on. Posting the next transfer before a compute
    and waiting after it is the overlap JAX leaves to XLA.

    A pair from a rank to itself is a copy under gloo, which has no pair
    to its own rank; NCCL takes it inside the batch, as the periodic
    self-exchange of ``comm/halo.py`` does."""
    _, rank = _size_rank(group)
    dsts = [d for s, d in perm if s == rank]
    srcs = [s for s, d in perm if d == rank]
    if len(dsts) > 1 or len(srcs) > 1:
        raise ValueError(f"perm {perm} sends or receives twice at rank {rank}")
    xs = [x.contiguous() for x in xs]
    outs = [torch.zeros_like(x) if not srcs else torch.empty_like(x)
            for x in xs]
    if dsts == [rank] and dist.get_backend(group) != "nccl":
        return [out.copy_(x) for out, x in zip(outs, xs)], []
    ops = []
    # group ranks -> the global ranks a P2P op names
    peer = (lambda r: r) if group is None else (
        lambda r: dist.get_global_rank(group, r))
    for x, out in zip(xs, outs):
        if dsts:
            ops.append(dist.P2POp(dist.isend, x, peer(dsts[0]), group))
        if srcs:
            ops.append(dist.P2POp(dist.irecv, out, peer(srcs[0]), group))
    return outs, dist.batch_isend_irecv(ops) if ops else []


def ppermute(x: torch.Tensor, perm, group=None) -> torch.Tensor:
    """``lax.ppermute``: send ``x`` along every (src, dst) pair of
    ``perm`` (group ranks); returns what this rank received, zeros where
    no pair sends to it (:func:`ppermute_start`, waited on)."""
    (out,), works = ppermute_start([x], perm, group)
    for work in works:
        work.wait()
    return out


# ---------------------------------------------------------------------------
# native arm


def allreduce(x: torch.Tensor, group=None,
              inplace: bool = False) -> torch.Tensor:
    """MPI_Allreduce(SUM) -> ``dist.all_reduce`` on a copy of ``x``, or
    with ``inplace`` on ``x`` itself (contiguous): the sweep's chained
    loop owns its carry, and a copy a step is a pass JAX's loop does not
    make."""
    out = x if inplace else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """MPI_Reduce_scatter_block -> ``dist.reduce_scatter_tensor``.

    ``x`` is the full per-rank buffer; rank i gets the i-th block of the
    global sum (JAX's tiled semantics: the leading axis of size n*k is
    split n ways).
    """
    n, _ = _size_rank(group)
    if x.shape[0] % n != 0:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by {n}")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
    return out


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """MPI_Allgather -> ``dist.all_gather_into_tensor`` (tiled:
    concatenate along axis 0)."""
    n, _ = _size_rank(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def bcast_psum(x: torch.Tensor, group=None, root: int = 0) -> torch.Tensor:
    """MPI_Bcast via mask + sum: every rank but ``root`` contributes
    zeros to an all-reduce. Not ``dist.broadcast``: its wire cost is an
    all-reduce, as the JAX formulation's."""
    _, rank = _size_rank(group)
    out = (x.clone(memory_format=torch.contiguous_format) if rank == root
           else torch.zeros_like(x, memory_format=torch.contiguous_format))
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


# ---------------------------------------------------------------------------
# explicit arm


def bcast_tree(x: torch.Tensor, group=None, root: int = 0) -> torch.Tensor:
    """MPI_Bcast as a binomial tree of point-to-point rounds (ceil(log2
    n) rounds).

    Round k: every rank at ring distance d < k from ``root`` that has a
    rank at d + k forwards the payload to it. JAX sends masked zeros
    from every rank and lets the receivers at k <= d < 2k take theirs;
    only those hops carry data, and only those are posted here (a send
    nobody receives would leave its rank waiting).
    """
    n, rank = _size_rank(group)
    if n == 1:
        return x
    d = (rank - root) % n
    out = x if d == 0 else None
    k = 1
    while k < n:
        perm = [((root + s) % n, (root + s + k) % n)
                for s in range(k) if s + k < n]
        if d < k and d + k < n:
            ppermute(out, perm, group)
        elif k <= d < 2 * k:
            out = ppermute(x, perm, group)
        k *= 2
    return out


def ring_reduce_scatter(
    x: torch.Tensor,
    group=None,
    wire_dtype: torch.dtype | None = None,
    acc_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Ring reduce-scatter: n-1 hops of one chunk each.

    Rank i returns chunk i of the global sum (leading axis split n ways,
    matching :func:`reduce_scatter`). ``wire_dtype`` casts each hop's
    payload (the "bf16 wire" arm); ``acc_dtype`` is the accumulation
    dtype (default: x.dtype; float32 for mixed precision).
    """
    n, i = _size_rank(group)
    if x.shape[0] % n != 0:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by {n}")
    acc_dtype = acc_dtype or x.dtype
    perm = ring_perm(n)
    # virtual relabeling: vchunk[c] = chunk[(c-1) % n]; the textbook ring
    # completes vchunk i+1 on rank i, which is real chunk i. ``roll``
    # copies, so the chunks are this function's own.
    chunks = torch.roll(
        x.reshape(n, x.shape[0] // n, *x.shape[1:]).to(acc_dtype), 1, 0
    )
    for k in range(n - 1):
        send = chunks[(i - k) % n]
        if wire_dtype is not None:
            send = send.to(wire_dtype)
        recvd = ppermute(send, perm, group).to(acc_dtype)
        chunks[(i - k - 1) % n].add_(recvd)
    return chunks[(i + 1) % n].to(x.dtype)


def ring_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Ring all-gather: n-1 hops, each forwarding the chunk received on
    the previous hop. Matches :func:`all_gather` (tiled)."""
    n, i = _size_rank(group)
    perm = ring_perm(n)
    out = x.new_zeros((n, *x.shape))
    out[i] = x
    cur = x
    for k in range(n - 1):
        cur = ppermute(cur, perm, group)
        out[(i - k - 1) % n] = cur
    return out.reshape((n * x.shape[0], *x.shape[1:]))


def ring_allreduce(
    x: torch.Tensor,
    group=None,
    wire_dtype: torch.dtype | None = None,
    acc_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Ring allreduce = ring reduce-scatter + ring all-gather: the
    bandwidth-optimal 2(n-1)/n algorithm, with optional low-precision
    wire and float32 accumulation (mixed-precision arm,
    BASELINE.json:11)."""
    scattered = ring_reduce_scatter(
        x, group, wire_dtype=wire_dtype, acc_dtype=acc_dtype
    )
    if wire_dtype is not None and scattered.dtype != wire_dtype:
        # the gather phase moves final values; wire dtype applies there too
        return ring_all_gather(
            scattered.to(wire_dtype), group
        ).to(x.dtype)
    return ring_all_gather(scattered, group)


def allreduce_mixed(
    x: torch.Tensor, group=None, compute_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Native-arm mixed-precision allreduce: upcast, all-reduce (float32
    wire and accumulation), downcast. The comparison point for the
    explicit bf16-wire ring."""
    return allreduce(x.to(compute_dtype), group).to(x.dtype)
