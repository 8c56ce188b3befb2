"""STREAM kernels of the membw driver: plain PyTorch versions + hand-written
CUDA kernels.

Port of the kernel half of ``tpu_comm/bench/membw.py`` (``_lax_body``,
the four Pallas bodies and the ``_chained`` loop). Arrays are flat with a
multiple of 128 elements (the TPU kernels' ``(rows, 128)`` view); a chunk
is ``rows_per_chunk`` rows of 128 elements and sets the launch grid, never
the result.

- ``step_torch``   — the ``torch`` arm (JAX ``lax``): one PyTorch op into a
  preallocated output. Not a kernel of this repo; the CPU and the card run
  it alike.
- ``step_chunked`` — wrapper of ``membw_unary`` (copy, scale) and
  ``membw_binary`` (add, triad) in ``csrc/membw.cu`` (JAX ``pallas``).
- ``step_stream``  — wrapper of ``membw_stream`` (``membw_stream_inplace``
  when aliased): the copy as a degenerate 1D stencil, every cell's two
  neighbour loads kept and folded in under a zero mask (JAX
  ``pallas-stream``).
- ``step_dma``     — wrapper of ``membw_dma``: the copy pipelined by hand
  through ``depth`` shared-memory slots with TMA bulk copies, a producer
  and a consumer lane on ``full``/``empty`` mbarriers (JAX
  ``pallas-dma``); :func:`dma_plan` sets its grid.

Each wrapper sends a CPU tensor to its plain version (``step_plain`` for
the chunked ops, ``copy_plain`` for the copies) and a CUDA tensor to its
kernel, or raises; ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_comm_torch.bench import MEMBW_IMPLS, MEMBW_OPS
from tpu_comm_torch.kernels.tiling import (
    DEFAULT_DMA_DEPTH,
    KERNEL_DTYPE_CODES,
    MAX_SMEM_BYTES,
    check_membw_args,
    f32_compute,
    launch_kernel,
    narrow_store,
)

LANES = 128
#: op codes of ``tc_membw_chunked`` (kCopy..kTriad in csrc/membw.cu)
OP_CODES = {"copy": 0, "scale": 1, "add": 2, "triad": 3}
BINARY_OPS = ("add", "triad")
#: default bytes of each operand a CTA of the chunked kernels takes, by
#: op: two 16-byte vectors a thread for copy, one for scale, add and triad,
#: the fastest of 4-64 KiB on the H100 (chip_smoke.py phase 5's sweep,
#: PERF.md §6)
CHUNKED_DEFAULT_CHUNK_BYTES = {"copy": 8 * 1024, "scale": 4 * 1024,
                               "add": 4 * 1024, "triad": 4 * 1024}
#: default bytes a CTA of the stream copy takes: two 16-byte vectors a
#: thread in float32, four in bfloat16/float16 (the fastest of 4-256 KiB
#: on the H100, PERF.md §6; the 1D stencil's own 8-row chunk gives the
#: 256 threads one float32 vector each, and the CTAs' launches then pace
#: the copy)
STREAM_DEFAULT_CHUNK_BYTES = 8 * 1024
#: default bytes per slot of the dma ring: as fast on the H100 as 8-64 KiB
#: slots (phase 5's sweep, PERF.md §6), and the one default whose ring
#: fits a CTA at every depth up to DMA_MAX_DEPTH
DMA_DEFAULT_CHUNK_BYTES = 16 * 1024
#: the dma ring's slot count bounds (kMaxDepth in csrc/membw.cu)
DMA_MAX_DEPTH = 8
#: the dma kernel's static shared memory: a ``full`` and an ``empty``
#: mbarrier of 8 bytes per slot of the deepest ring
DMA_BARRIER_BYTES = 2 * 8 * DMA_MAX_DEPTH
#: shared memory the card reserves for each resident CTA (1 KiB on sm_90,
#: cudaDevAttrReservedSharedMemoryPerBlock)
SMEM_RESERVED_PER_CTA = 1024
#: resident CTAs an SM holds at most (sm_90)
MAX_CTAS_PER_SM = 32


@dataclasses.dataclass(frozen=True)
class DmaPlan:
    """The dma kernel's launch: ``ctas`` CTAs, each with a ring of
    ``ring_bytes`` (``depth`` slots of ``chunk_bytes``); CTA ``b`` takes
    chunks ``b, b + ctas, ...`` of the ``n_chunks`` (:meth:`chunks_of`).
    ``per_sm`` CTAs fit on an SM at once."""

    chunk_bytes: int
    n_chunks: int
    ring_bytes: int
    per_sm: int
    ctas: int

    def chunks_of(self, cta: int) -> range:
        return range(cta, self.n_chunks, self.ctas)


def check_dma_ring(itemsize: int, rows_per_chunk: int, depth: int,
                   smem_per_cta: int = MAX_SMEM_BYTES) -> None:
    """Refuse a dma ring (``depth`` slots of ``rows_per_chunk`` rows) that
    does not fit the ``smem_per_cta`` bytes of shared memory a block may
    use (the H100's by default)."""
    ring = depth * rows_per_chunk * LANES * itemsize
    if ring + DMA_BARRIER_BYTES > smem_per_cta:
        raise ValueError(
            f"the dma ring ({depth} slots x {rows_per_chunk} rows = {ring} "
            f"B) exceeds the {smem_per_cta} B of shared memory a block can "
            "use"
        )


def check_depth(depth: int) -> None:
    """Refuse a dma ring of fewer than 2 or more than
    :data:`DMA_MAX_DEPTH` slots."""
    if not 2 <= depth <= DMA_MAX_DEPTH:
        raise ValueError(
            f"depth must be in [2, {DMA_MAX_DEPTH}], got {depth}: one slot "
            "cannot overlap its own load and store"
        )


def check_chunk(impl: str, itemsize: int, rows_per_chunk: int,
                depth: int | None = None) -> None:
    """Refuse a chunk a kernel arm's wrapper would not launch: below one
    row, or (dma, given a ``depth``) a ring that does not fit a CTA of the
    H100 (the wrapper checks the ring against its own card, in
    :func:`dma_plan`). The planner's legality
    (``tiling.flat_chunk_candidates``)."""
    if impl not in ("chunked", "stream", "dma"):
        raise ValueError(f"--impl {impl} takes no chunk (the kernel arms: "
                         "chunked, stream, dma)")
    if rows_per_chunk < 1:
        raise ValueError(f"rows_per_chunk must be >= 1, got {rows_per_chunk}")
    if impl == "dma" and depth is not None:
        check_dma_ring(itemsize, rows_per_chunk, depth)


def dma_plan(n: int, itemsize: int, rows_per_chunk: int, depth: int,
             sms: int, smem_per_sm: int, smem_per_cta: int) -> DmaPlan:
    """The dma kernel's grid for ``n`` elements of ``itemsize`` bytes in
    slots of ``rows_per_chunk`` rows: as many CTAs as the ring's shared
    memory lets reside on the ``sms`` SMs at once (``smem_per_sm`` bytes
    an SM, ``smem_per_cta`` at most a CTA), never more than there are
    chunks. Raises ValueError when one ring does not fit a CTA."""
    check_dma_ring(itemsize, rows_per_chunk, depth, smem_per_cta)
    chunk_bytes = rows_per_chunk * LANES * itemsize
    ring = depth * chunk_bytes
    per_sm = min(MAX_CTAS_PER_SM, smem_per_sm // (
        ring + DMA_BARRIER_BYTES + SMEM_RESERVED_PER_CTA))
    n_chunks = -(-n * itemsize // chunk_bytes)
    ctas = min(n_chunks, sms * max(per_sm, 1))
    return DmaPlan(chunk_bytes, n_chunks, ring, per_sm, ctas)


def dma_verify_size(n: int, itemsize: int, rows_per_chunk: int, depth: int,
                    sms: int, smem_per_sm: int, smem_per_cta: int) -> int:
    """Elements the dma arm's ``--verify`` copies on a card with these
    limits: the fewest at which every CTA of :func:`dma_plan` takes
    ``depth + 1`` chunks, so that every slot of every ring is refilled
    once, capped at the measured size ``n`` (whose timed loop then wraps
    no ring either). Raises ValueError where :func:`dma_plan` does."""
    plan = dma_plan(n, itemsize, rows_per_chunk, depth, sms, smem_per_sm,
                    smem_per_cta)
    ctas = sms * max(plan.per_sm, 1)
    return min(n, ctas * (depth + 1) * rows_per_chunk * LANES)


def check_op(op: str) -> None:
    if op not in MEMBW_OPS:
        raise ValueError(f"op must be one of {MEMBW_OPS}, got {op!r}")


def default_chunk(impl: str, dtype: torch.dtype, op: str = "copy") -> int:
    """The rows per chunk a kernel arm uses for ``op`` when the caller
    passes none: a fixed number of bytes a CTA (a ring slot for dma), the
    same in every dtype."""
    chunk_bytes = (CHUNKED_DEFAULT_CHUNK_BYTES[op] if impl == "chunked" else
                   {"stream": STREAM_DEFAULT_CHUNK_BYTES,
                    "dma": DMA_DEFAULT_CHUNK_BYTES}[impl])
    return chunk_bytes // (LANES * dtype.itemsize)


def _chunk(rows_per_chunk: int | None, impl: str, dtype: torch.dtype,
           op: str = "copy") -> int:
    if rows_per_chunk is None:
        return default_chunk(impl, dtype, op)
    check_chunk(impl, dtype.itemsize, rows_per_chunk)
    return rows_per_chunk


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"CUDA kernel needs a CUDA tensor, got {x.device}")


def step_plain(x: torch.Tensor, b: torch.Tensor | None, s: float, op: str,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One STREAM op in plain PyTorch, the chunked kernels' arithmetic:
    ``s`` narrowed to the field dtype and widened, f32 compute (triad as
    ``b + (x * s)``, two roundings in f32), one RTNE narrowing."""
    check_op(op)
    if op == "copy":
        return copy_plain(x, out)
    sv = torch.tensor(s, dtype=x.dtype).item()
    a = f32_compute(x)
    if op == "scale":
        r = a * sv
    elif op == "add":
        r = a + f32_compute(b)
    else:
        r = f32_compute(b) + a * sv
    return narrow_store(r, x.dtype, out)


def copy_plain(x: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The copies' plain version: ``out.copy_(x)``."""
    return x.clone() if out is None else out.copy_(x)


def step_chunked(x: torch.Tensor, b: torch.Tensor | None, s: float, op: str,
                 rows_per_chunk: int | None = None, aliased: bool = False,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """One STREAM ``op`` pass (``o = x``, ``x·s``, ``x + b``, ``b + x·s``).
    ``b`` is read by add and triad only. With ``aliased`` the result is
    written into ``x``. ``step_chunked.launches`` counts launches of both
    kernels."""
    check_op(op)
    binary = op in BINARY_OPS
    if binary and b is None:
        raise ValueError(f"op {op!r} needs the second operand b")
    out = check_membw_args(x, out, aliased, *((b,) if binary else ()))
    rows = _chunk(rows_per_chunk, "chunked", x.dtype, op)
    if x.device.type == "cpu":
        return step_plain(x, b, s, op, out)
    _require_cuda(x)
    launch_kernel(
        "tc_membw_chunked", x, x.data_ptr(),
        b.data_ptr() if binary else None, out.data_ptr(), x.numel(),
        KERNEL_DTYPE_CODES[x.dtype], OP_CODES[op], float(s), rows,
    )
    step_chunked.launches += 1
    return out


def step_stream(x: torch.Tensor, rows_per_chunk: int | None = None,
                out: torch.Tensor | None = None,
                aliased: bool = False) -> torch.Tensor:
    """One copy as a degenerate 1D stencil: every cell's two neighbours
    are read and folded in under a zero mask, one CTA a chunk. With
    ``aliased`` the copy runs in place (value-safe: a neighbour read
    that races a write sees the same bits either way)."""
    out = check_membw_args(x, out, aliased)
    rows = _chunk(rows_per_chunk, "stream", x.dtype)
    if x.device.type == "cpu":
        return copy_plain(x, out)
    _require_cuda(x)
    launch_kernel("tc_membw_stream", x, x.data_ptr(), out.data_ptr(),
                  x.numel(), KERNEL_DTYPE_CODES[x.dtype], rows)
    step_stream.launches += 1
    return out


def step_dma(x: torch.Tensor, rows_per_chunk: int | None = None,
             depth: int = DEFAULT_DMA_DEPTH,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """One copy pipelined by hand through ``depth`` shared-memory slots of
    ``rows_per_chunk`` rows each. ``out`` must not alias ``x`` and both
    must be 16-byte aligned (TMA bulk copies)."""
    check_depth(depth)
    out = check_membw_args(x, out)
    rows = _chunk(rows_per_chunk, "dma", x.dtype)
    if x.device.type == "cpu":
        return copy_plain(x, out)
    _require_cuda(x)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("the dma copy needs 16-byte aligned tensors (TMA "
                         "bulk copies); got an offset view")
    props = torch.cuda.get_device_properties(x.device)
    plan = dma_plan(x.numel(), x.element_size(), rows, depth,
                    props.multi_processor_count,
                    props.shared_memory_per_multiprocessor,
                    props.shared_memory_per_block_optin)
    launch_kernel("tc_membw_dma", x, x.data_ptr(), out.data_ptr(), x.numel(),
                  KERNEL_DTYPE_CODES[x.dtype], rows, depth, plan.ctas)
    step_dma.launches += 1
    return out


step_chunked.launches = 0
step_stream.launches = 0
step_dma.launches = 0
#: every kernel wrapper of this module (chip_smoke.py resets and reads
#: their counts)
WRAPPERS = (step_chunked, step_stream, step_dma)


def step_torch(x: torch.Tensor, b: torch.Tensor, s: torch.Tensor,
               z: torch.Tensor, op: str,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The ``torch`` arm's body (JAX ``_lax_body``): one PyTorch op into
    ``out``, with ``s`` and ``z`` 0-d tensors already in ``x``'s dtype.
    copy is ``x + z`` (not an identity, as in the lax arm); triad is
    ``b + x·s`` as one ``addcmul``."""
    check_op(op)
    if out is None:
        out = torch.empty_like(x)
    if op == "copy":
        return torch.add(x, z, out=out)
    if op == "scale":
        return torch.mul(x, s, out=out)
    if op == "add":
        return torch.add(x, b, out=out)
    return torch.addcmul(b, x, s, out=out)


def chained(x: torch.Tensor, b: torch.Tensor, s: float, z: float, op: str,
            impl: str, iters: int, rows_per_chunk: int | None = None,
            aliased: bool = False,
            depth: int = DEFAULT_DMA_DEPTH) -> torch.Tensor:
    """``iters`` chained applications of ``op`` through arm ``impl``
    (JAX ``_chained``); returns the iterate. ``x`` itself is only read.

    The loop ping-pongs two buffers allocated once per call, as
    ``kernels.run_steps`` does; with ``aliased`` it copies ``x`` once and
    runs every pass in place. ``s`` and ``z`` are the runtime scalar and
    zero (1.0 and 0.0 in the timed loop: every op is then the identity).
    """
    check_op(op)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if impl in ("stream", "dma") and op != "copy":
        raise ValueError(f"the {impl} arm is a copy arm (op='copy' only)")
    if impl == "torch":
        if aliased:
            raise ValueError("aliased applies to the kernel arms only")
        st, zt = (
            torch.full((), v, dtype=torch.float32, device=x.device).to(x.dtype)
            for v in (s, z)
        )

        def step(src, dst):
            return step_torch(src, b, st, zt, op, out=dst)
    elif impl == "chunked":
        def step(src, dst):
            return step_chunked(src, b, s, op, rows_per_chunk, aliased,
                                out=dst)
    elif impl == "stream":
        def step(src, dst):
            return step_stream(src, rows_per_chunk, out=dst, aliased=aliased)
    elif impl == "dma":
        if aliased:
            raise ValueError("the dma arm owns its schedule; aliased does "
                             "not apply to it")

        def step(src, dst):
            return step_dma(src, rows_per_chunk, depth, out=dst)
    else:
        raise ValueError(f"impl must be one of {MEMBW_IMPLS}, got {impl!r}")
    if iters == 0:
        return x.clone()
    if aliased:
        buf = x.clone()
        for _ in range(iters):
            step(buf, buf)
        return buf
    bufs = (torch.empty_like(x), torch.empty_like(x))
    src = x
    for i in range(iters):
        src = step(src, bufs[i % 2])
    return src
