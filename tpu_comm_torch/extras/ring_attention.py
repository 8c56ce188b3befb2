"""Ring attention and Ulysses (all-to-all) sequence parallelism (port of
``tpu_comm/extras/ring_attention.py``, same names).

Two standard long-context strategies over a 1D ring of ranks:

- :func:`ring_attention`: each rank holds a sequence block of Q/K/V; the
  K/V blocks rotate around the ring (``collectives.ring_perm``) while a
  streaming (flash-style) softmax accumulates the partial results. A
  rank never holds more than one K/V block and one score block.
- :func:`ulysses_attention`: one ``all_to_all_single`` reshards from
  sequence-sharded to head-sharded, full attention runs per local head,
  and a second ``all_to_all_single`` reshards back.

Both are exact: they match full single-rank attention
(:func:`reference_attention`) to float32 tolerance.

JAX runs these inside ``shard_map`` over a mesh axis; here each function
runs on this rank's blocks and is collective over ``group`` (default:
the default process group): every rank of it calls it with blocks of
the same shape. The products are ``torch.matmul`` (TF32 off, torch's
default, so JAX's float32 tolerance holds); no kernel of the port runs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from tpu_comm_torch.comm.collectives import (
    _size_rank,
    ppermute_start,
    ring_perm,
)

_NEG_BIG = -1e30  # mask value: large-negative, exp()-safe in fp32


def _block_attn(q, k, v, m, l, o, q_start: int, k_start: int,
                causal: bool):
    """One streaming-softmax accumulation step over a K/V block.

    ``(m, l, o)`` is the flash-attention running state (row max, row
    normalizer, unnormalized output), float32; ``q_start``/``k_start``
    are the blocks' global sequence offsets, used only for the causal
    mask. Leading dimensions of ``q``, ``k``, ``v`` (heads) batch."""
    d = q.shape[-1]
    s = (q @ k.transpose(-1, -2)).float() / math.sqrt(d)
    if causal:
        qi = q_start + torch.arange(q.shape[-2], device=q.device)[:, None]
        ki = k_start + torch.arange(k.shape[-2], device=q.device)[None, :]
        s = torch.where(ki <= qi, s, _NEG_BIG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = corr * l + p.sum(dim=-1)
    o_new = corr[..., None] * o + p @ v.float()
    return m_new, l_new, o_new


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    causal: bool = False,
) -> torch.Tensor:
    """Exact attention over a ring-sharded sequence.

    ``q``/``k``/``v`` are this rank's sequence blocks, ``(block, d)``, or
    ``(block, heads, d)`` for many heads: the heads are a batch axis of
    one ring, one transfer a hop carrying every head's block, which is
    what the JAX bench's ``jax.vmap`` over heads makes of its
    ``ppermute``. Rank i attends block ``(i + t) % n`` at hop t.

    The transfer of hop t + 1's K/V is posted before hop t's block
    compute and waited on after it: the overlap JAX leaves to XLA; it
    changes no value. JAX rotates n times; the last rotation carries
    data nobody reads, so the port makes n - 1 hops, the wire that the
    bench row's ``ring_bytes_per_chip_per_iter`` counts.
    """
    n, i = _size_rank(group)
    heads = q.dim() == 3
    if heads:  # (block, H, d) -> (H, block, d): the heads batch
        q, k, v = (x.transpose(0, 1) for x in (q, k, v))
    bq, bk = q.shape[-2], k.shape[-2]
    # send each block DOWN the ring (shift -1): after t hops rank i holds
    # block (i + t) % n, so hop 0 is the diagonal block, which under
    # causal=True seeds a finite row max before any masked block
    down = ring_perm(n, -1)
    m = q.new_full(q.shape[:-1], _NEG_BIG, dtype=torch.float32)
    l = q.new_zeros(q.shape[:-1], dtype=torch.float32)
    o = q.new_zeros(q.shape, dtype=torch.float32)
    q_start = i * bq
    k_cur, v_cur = k, v
    for t in range(n):
        hop = t < n - 1
        if hop:
            nxt, works = ppermute_start((k_cur, v_cur), down, group)
        src = (i + t) % n
        # a block from rank src > i lies wholly in this query block's
        # future under causal: JAX's lax.cond skips its compute
        if not (causal and src > i):
            m, l, o = _block_attn(q, k_cur, v_cur, m, l, o, q_start,
                                  src * bk, causal)
        if hop:
            for work in works:
                work.wait()
            k_cur, v_cur = nxt
    out = (o / l[..., None]).to(q.dtype)
    return out.transpose(0, 1).contiguous() if heads else out


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    causal: bool = False,
) -> torch.Tensor:
    """Exact attention via all-to-all head/sequence resharding.

    Local shapes are ``(block, heads, d)`` with the sequence sharded over
    the ranks and ``heads`` divisible by their number. One all-to-all
    turns the layout into (full seq, heads/n, d); full attention runs per
    local head; a second all-to-all restores sequence sharding. The
    element order is that of JAX's ``tiled=False`` ``all_to_all``.
    """
    n, _ = _size_rank(group)
    block, heads, d = q.shape
    if heads % n != 0:
        raise ValueError(f"heads {heads} not divisible by axis size {n}")
    hn = heads // n

    def gather_heads(x):  # (block, H, d) -> (n*block, H/n, d)
        # chunk j (head group j) to rank j; chunk j back from rank j is
        # its sequence block: JAX's split_axis=1, concat_axis=0
        send = x.reshape(block, n, hn, d).permute(1, 0, 2, 3).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv.reshape(n * block, hn, d)

    qg, kg, vg = gather_heads(q), gather_heads(k), gather_heads(v)
    # per local head, batched: (H/n, n*block, d)
    qh, kh, vh = (x.transpose(0, 1) for x in (qg, kg, vg))
    s = (qh @ kh.transpose(-1, -2)).float() / math.sqrt(d)
    if causal:
        idx = torch.arange(s.shape[-1], device=s.device)
        s = torch.where(idx[None, :] <= idx[:, None], s, _NEG_BIG)
    p = torch.softmax(s, dim=-1)
    og = (p @ vh.float()).to(q.dtype).transpose(0, 1)  # (n*block, H/n, d)

    # inverse reshard: sequence block j goes home to rank j; what comes
    # back from rank j is head group j (JAX's split_axis=0, concat_axis=1)
    send = og.reshape(n, block, hn, d).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 0, 2, 3).reshape(block, heads, d)


def reference_attention(q, k, v, causal: bool = False):
    """Single-device golden: full softmax attention, (seq, d) or
    (seq, heads, d) layouts (NumPy, float32)."""
    q = np.asarray(q, np.float32)
    k = np.asarray(k, np.float32)
    v = np.asarray(v, np.float32)
    if q.ndim == 3:
        out = np.stack(
            [reference_attention(q[:, h], k[:, h], v[:, h], causal)
             for h in range(q.shape[1])], axis=1,
        )
        return out
    s = q @ k.T / np.sqrt(q.shape[-1])
    if causal:
        idx = np.arange(s.shape[0])
        s = np.where(idx[None, :] <= idx[:, None], s, _NEG_BIG)
    s = s - s.max(axis=1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(axis=1, keepdims=True)
    return p @ v


def run_ring_attention(q, k, v, causal: bool = False, impl: str = "ring"):
    """Convenience driver: every rank of the default group passes the same
    global ``(seq, ...)`` arrays (NumPy or CPU tensors); each takes its
    sequence block, runs the chosen implementation on the current CUDA
    device under NCCL (else the CPU), and the blocks are gathered: rank 0
    returns the global result, the other ranks None."""
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[impl]
    n, rank = _size_rank(None)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    blocks = []
    for x in (q, k, v):
        x = torch.as_tensor(x)
        if x.shape[0] % n != 0:
            raise ValueError(
                f"seq {x.shape[0]} not divisible by {n} devices")
        per = x.shape[0] // n
        blocks.append(x[rank * per:(rank + 1) * per].to(device))
    out = fn(*blocks, causal=causal)
    gathered = [torch.empty_like(out) for _ in range(n)]
    dist.all_gather(gathered, out.contiguous())
    return torch.cat(gathered) if rank == 0 else None
