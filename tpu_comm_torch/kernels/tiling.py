"""The kernels' dtype contract, argument checks and the field's
host/device form.

Port of the dtype half of ``tpu_comm/kernels/tiling.py``
(``f32_compute``, ``narrow_store``, ``check_pallas_dtype``) and of its
row ``knob_tag`` and ``DEFAULT_DMA_DEPTH``. Every kernel
and every plain version computes in float32 and narrows once per step
with round-to-nearest-even; HBM traffic stays in the field's dtype. The
TPU arm's VMEM budget planner has no counterpart here: the CUDA kernels
take any chunk.

Hopper loads float16 natively, so the TPU package's int16 wire for f16
(``kernels/f16.py``) is not needed; its RTNE contract still holds, since
PyTorch's and CUDA's float->half/bfloat16 conversions round to nearest
even.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from tpu_comm_torch.kernels._build import launch

#: field dtypes the stencil kernels take, by the driver's ``--dtype`` name
DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
#: dtype codes of the CUDA launchers (kFloat32/kBFloat16/kFloat16 in
#: csrc/jacobi_stream.cu and csrc/membw.cu)
KERNEL_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a ``--dtype`` name; ValueError if unsupported."""
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {tuple(DTYPES)}, got {name!r}")
    return DTYPES[name]


def f32_compute(a: torch.Tensor) -> torch.Tensor:
    """Widen a sub-32-bit field to float32 (exact); identity for f32."""
    return a if a.dtype == torch.float32 else a.float()


def narrow_store(
    x: torch.Tensor, dtype: torch.dtype, out: torch.Tensor | None = None
) -> torch.Tensor:
    """Narrow an f32 result to ``dtype`` (round to nearest even), into
    ``out`` when given."""
    if out is None:
        return x.to(dtype)
    return out.copy_(x)


def check_kernel_args(
    u: torch.Tensor, ndim: int, out: torch.Tensor | None,
    min_extents: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Validate a CUDA kernel's input; return ``out`` (allocated with
    ``torch.empty_like`` when None). Raises on what the kernels do not
    take: another device, dtype, rank, a non-contiguous tensor, an extent
    below its minimum (3 unless ``min_extents`` says otherwise), or an
    output that aliases the input or differs in form."""
    if u.device.type != "cuda":
        raise ValueError(f"CUDA kernel needs a CUDA tensor, got {u.device}")
    if u.dtype not in KERNEL_DTYPE_CODES:
        raise ValueError(
            f"CUDA kernel takes {tuple(DTYPES)}, got {u.dtype}"
        )
    if u.dim() != ndim:
        raise ValueError(
            f"expected a {ndim}-D field, got shape {tuple(u.shape)}"
        )
    if min_extents is None:
        min_extents = (3,) * ndim
    if any(s < m for s, m in zip(u.shape, min_extents)):
        raise ValueError(
            f"the extents must be >= {min_extents}, got {tuple(u.shape)}"
        )
    if not u.is_contiguous():
        raise ValueError("CUDA kernel needs a contiguous field")
    if out is None:
        return torch.empty_like(u, memory_format=torch.contiguous_format)
    if (
        out.shape != u.shape
        or out.dtype != u.dtype
        or out.device != u.device
        or not out.is_contiguous()
    ):
        raise ValueError(
            "out must be a contiguous tensor of the input's shape, dtype "
            "and device"
        )
    if out.data_ptr() == u.data_ptr():
        raise ValueError("out must not alias the input (Jacobi reads the "
                         "old field while writing the new one)")
    return out


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors' byte ranges share any byte."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a.device == b.device and a0 < b1 and b0 < a1


def check_membw_args(
    x: torch.Tensor, out: torch.Tensor | None, aliased: bool = False,
    *others: torch.Tensor,
) -> torch.Tensor:
    """Validate the input of a membw kernel or its plain version; return
    the output (``x`` itself when ``aliased`` and ``out`` is None,
    else ``out``, allocated when None).

    ``x`` and every operand in ``others`` must be contiguous tensors of
    one shape, dtype and device, of the kernels' dtypes, with a multiple
    of 128 elements (the TPU kernels' ``(rows, 128)`` view). ``out`` may
    be ``x`` exactly when ``aliased`` (the in-place knob); any other
    overlap of ``out`` with an input is refused."""
    if x.dtype not in KERNEL_DTYPE_CODES:
        raise ValueError(f"membw kernels take {tuple(DTYPES)}, got {x.dtype}")
    if x.numel() < 128 or x.numel() % 128:
        raise ValueError(
            f"membw kernels need a multiple of 128 elements, got {x.numel()}"
        )
    for t in (x, *others):
        if not t.is_contiguous():
            raise ValueError("membw kernels need contiguous tensors")
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                "every operand must have the input's shape, dtype and device"
            )
    if out is None:
        return x if aliased else torch.empty_like(x)
    if (
        out.shape != x.shape
        or out.dtype != x.dtype
        or out.device != x.device
        or not out.is_contiguous()
    ):
        raise ValueError(
            "out must be a contiguous tensor of the input's shape, dtype "
            "and device"
        )
    if aliased:
        if out.data_ptr() != x.data_ptr():
            raise ValueError("aliased=True writes into the input: out must "
                             "be the input itself")
    elif _overlaps(out, x):
        raise ValueError("out must not alias the input unless aliased=True")
    if any(_overlaps(out, t) for t in others):
        raise ValueError("out must not alias the second operand")
    return out


#: the manual DMA copy's classic double-buffered slot count (the JAX
#: package's ``tiling.DEFAULT_DMA_DEPTH``)
DEFAULT_DMA_DEPTH = 2


def knob_tag(aliased: bool = False, depth: int | None = None) -> dict:
    """The row's ``knobs`` fragment, as the JAX package's
    ``tiling.knob_tag`` writes it: only non-default knobs appear
    (``aliased`` when set, ``depth`` when not the default 2). The JAX
    ``dimsem`` knob has no counterpart here: CUDA blocks are unordered."""
    tag = {}
    if aliased:
        tag["aliased"] = True
    if depth is not None and depth != DEFAULT_DMA_DEPTH:
        tag["depth"] = int(depth)
    return tag


def launch_kernel(symbol: str, t: torch.Tensor, *args) -> None:
    """Call the C launcher ``symbol`` of ``csrc/`` on ``t``'s device with
    ``args`` and, last, the device's current stream (its raw handle).
    The device becomes current for the call only where it is not
    already."""
    index = t.get_device()
    current = index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(index):
        launch(symbol, *args, torch._C._cuda_getCurrentRawStream(index))


def launch_stencil(symbol: str, u: torch.Tensor, out: torch.Tensor, bc: str,
                   chunk: int | None = None) -> None:
    """Launch a stencil kernel of ``csrc/`` on ``u``'s device and current
    stream. Every launcher takes ``(u, out, *extents, dtype code,
    periodic[, chunk], stream)``: the stream kernels take a chunk, the
    block kernels none. Validate ``u`` and ``out`` with
    :func:`check_kernel_args` first."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    launch_kernel(
        symbol, u, u.data_ptr(), out.data_ptr(), *u.shape,
        KERNEL_DTYPE_CODES[u.dtype], int(bc == "periodic"),
        *(() if chunk is None else (chunk,)),
    )


#: the most steps one launch of ``csrc/multi.cu`` runs, by field rank
#: (its kTMax1, kTMax2, kTMax3; in 2D the levels a lane's registers hold,
#: in 3D one kernel instantiation a step count); a wrapper asked for more
#: chains launches
MULTI_T_MAX = {1: 256, 2: 8, 3: 4}
#: the dynamic shared memory a block may use on sm_90 (``csrc/multi.cu``
#: kMaxSmem)
MAX_SMEM_BYTES = 232448
#: the most window a 3D wavefront block holds, rows and columns
#: (``csrc/multi.cu`` kWinY, kWinX: its planes lie in shared memory at a
#: fixed row stride), the window rows of one column a thread owns
#: (kRows3), and the threads that makes (kMaxThreads3; two blocks to an
#: SM)
MULTI3D_WINDOW = (32, 64)
MULTI3D_ROWS = 4
MULTI3D_MAX_THREADS = MULTI3D_WINDOW[0] * MULTI3D_WINDOW[1] // MULTI3D_ROWS
#: grid.y is limited to 65535 blocks
MAX_GRID_Y = 65535


#: the dynamic shared memory the grid and wave kernels may ask for
#: (``csrc/grid.cu``, ``csrc/wave.cu`` kMaxSmem: a block's 232448 bytes
#: less room for their static barriers)
STAGED_MAX_SMEM = MAX_SMEM_BYTES - 1024
#: the 2D grid kernel's tile width and the 2D wave kernel's strip width,
#: in columns (``csrc/grid.cu`` kTileX, ``csrc/wave.cu`` kStripX)
STAGED_TILE_X = 256
#: the wave kernels' ring slots (``csrc/wave.cu`` kSlots)
WAVE_SLOTS = 4
#: the 27-point wave kernel's ring slots (its consumers hold one plane at
#: a time) and its most tile rows, whose per-row sums live in registers
#: (``csrc/wave.cu`` kSlots27, kMaxRows27)
WAVE3D_SLOTS = 3
WAVE3D_MAX_ROWS = 16
#: the shared memory the grid and wave kernels' default chunks give a
#: float32 CTA (a 2-byte field takes about half): six fit an SM's 227 KB,
#: 1536 of its 2048 threads, so copies stay in flight while a CTA
#: computes. The counterpart of the TPU arms' VMEM budget
#: (``_auto_rows_grid``, ``_auto_rows_wave``).
STAGED_SMEM_TARGET = 36 * 1024


def staged_bytes(cols: int, itemsize: int) -> int:
    """Shared memory that stages ``cols`` columns of a row
    (``csrc/staging.cuh`` staged_bytes: the row plus the slack that
    keeps it at its global address modulo 16)."""
    return (cols * itemsize + 32 + 15) // 16 * 16


def grid_smem(dim: int, rows: int, itemsize: int) -> int:
    """A grid kernel CTA's window: 1D ``rows`` x 128 cells and a halo cell
    each side; 2D ``rows`` + 2 staged rows of the tile and its two halo
    columns."""
    if dim == 1:
        return staged_bytes(rows * 128 + 2, itemsize)
    return (rows + 2) * staged_bytes(STAGED_TILE_X + 2, itemsize)


def wave_smem(dim: int, rows: int, itemsize: int) -> int:
    """A wave kernel CTA's ring: ``WAVE_SLOTS`` blocks of ``rows`` x 128
    cells (1D) or of ``rows`` staged strip rows, plus the two halo rows
    (2D), or ``WAVE3D_SLOTS`` planes of a tile of ``rows`` staged strip
    rows, each with a halo row above and below (3D, the 27-point box)."""
    row = staged_bytes(STAGED_TILE_X + 2, itemsize)
    if dim == 1:
        return WAVE_SLOTS * staged_bytes(rows * 128, itemsize)
    if dim == 2:
        return (WAVE_SLOTS * rows + 2) * row
    return WAVE3D_SLOTS * (rows + 2) * row


def staged_default_rows(smem, dim: int) -> int:
    """The most rows, a multiple of 8, whose float32 CTA ``smem(dim, rows,
    4)`` stays within :data:`STAGED_SMEM_TARGET`."""
    rows = 8
    while smem(dim, rows + 8, 4) <= STAGED_SMEM_TARGET:
        rows += 8
    return rows


def check_staged_smem(arm: str, smem: int, chunk: int) -> None:
    """Refuse a chunk whose window or ring exceeds a CTA's shared
    memory."""
    if smem > STAGED_MAX_SMEM:
        raise ValueError(
            f"chunk {chunk}: the {arm} kernel's CTA would need {smem} bytes "
            f"of shared memory; it may have {STAGED_MAX_SMEM}"
        )


def check_ghosts(u: torch.Tensor, ghosts, shapes, what: str,
                 out: torch.Tensor | None) -> list[torch.Tensor]:
    """Validate the ghost lines of a ghost-fed kernel or its plain
    version: each of ``ghosts`` must have its shape in ``shapes`` (the
    JAX wrapper's message names the ``what``), ``u``'s dtype and device;
    ``out`` must not alias ``u``. Returns the ghosts contiguous."""
    got = [tuple(g.shape) for g in ghosts]
    want = [tuple(s) for s in shapes]
    if got != want:
        raise ValueError(
            f"ghost {what} must be {' / '.join(map(str, want))}, got "
            f"{' / '.join(map(str, got))}"
        )
    for g in ghosts:
        if g.dtype != u.dtype or g.device != u.device:
            raise ValueError(
                f"ghost {what} must have the block's dtype and device "
                f"({u.dtype}, {u.device}), got {g.dtype}, {g.device}"
            )
    if out is not None and out.data_ptr() == u.data_ptr():
        raise ValueError("out must not alias the input (Jacobi reads the "
                         "old field while writing the new one)")
    return [g.contiguous() for g in ghosts]


def check_wave_bc(bc: str) -> None:
    """The wave arm is dirichlet only, as JAX's ``pallas-wave``."""
    if bc != "dirichlet":
        raise ValueError(
            "wave supports bc='dirichlet' only, as JAX's pallas-wave (its "
            "frozen edges are the TPU pipeline's junk barrier); use stream "
            "for periodic"
        )


def check_multi3d_bc(bc: str) -> None:
    """The 3D multi arm is dirichlet only, as JAX's 3D ``pallas-multi``."""
    if bc != "dirichlet":
        raise ValueError(
            "multi in 3D (the wavefront) supports bc='dirichlet' only, as "
            "JAX's pallas-multi (the frozen shell is the wavefront's "
            "barrier); use stream for periodic"
        )


def check_t_steps(t_steps: int) -> None:
    """The steps of a temporal-blocking pass: at least 1."""
    if t_steps < 1:
        raise ValueError(f"t_steps must be >= 1, got {t_steps}")


def multi_passes(t_steps: int, t_max: int) -> list[int]:
    """The steps each launch of a ``t_steps`` pass runs: ``t_max`` a
    launch, the last one the rest."""
    check_t_steps(t_steps)
    full, rest = divmod(t_steps, t_max)
    return [t_max] * full + ([rest] if rest else [])


def multi3d_threads(tile: tuple[int, int], halo: int) -> int:
    """The threads of a 3D wavefront block: its window's columns times
    its rows in groups of :data:`MULTI3D_ROWS`."""
    return (tile[1] + 2 * halo) * -(-(tile[0] + 2 * halo) // MULTI3D_ROWS)


def multi3d_block_tile(tile: tuple[int, int], halo: int,
                       extents: tuple[int, int]) -> tuple[int, int]:
    """The tile a 3D wavefront block takes for a requested ``tile`` of a
    field whose planes are ``extents`` (rows, columns): the tile cut to
    the field and to the most a block's window holds with its
    ``halo``-cell apron (:data:`MULTI3D_WINDOW`). The tile sets the grid,
    never the result, so every tile of at least one cell is taken."""
    if min(tile) < 1:
        raise ValueError(f"the tile must be >= 1 cell a side, got {tile}")
    return tuple(min(n, e, w - 2 * halo)
                 for n, e, w in zip(tile, extents, MULTI3D_WINDOW))


def multi3d_default_tile(halo: int) -> tuple[int, int]:
    """The tile a 3D wavefront block takes by default with a
    ``halo``-cell apron: the largest whose window it holds, but at a
    halo of 1 half the window's rows, so that four blocks of 256 threads
    share an SM (a plane step is short there, and smaller blocks' barriers
    stall fewer warps; it timed faster on the H100)."""
    rows, cols = MULTI3D_WINDOW
    if halo == 1:
        rows //= 2
    return rows - 2 * halo, cols - 2 * halo


def multi_smem(dim: int, tile: tuple[int, ...], halo: int) -> int:
    """The shared memory of a 1D or 3D multi kernel's block: two float32
    buffers of the window (1D), or two float32 planes of the most window a
    block holds, each with a spare row above and below, for each of the
    ``halo`` levels below the last (3D)."""
    if dim == 3:
        return 2 * halo * 4 * MULTI3D_WINDOW[1] * (MULTI3D_WINDOW[0] + 2)
    return 2 * 4 * (tile[0] + 2 * halo)


def check_multi_tile(dim: int, tile: tuple[int, ...], halo: int) -> None:
    """Refuse a block tile whose window does not fit a block: in 3D the
    window a block holds (:data:`MULTI3D_WINDOW`; :func:`multi3d_block_tile`
    cuts a requested tile to one that fits), in 1D its shared memory. A 2D tile
    of any size fits: its block is one warp that walks the tile."""
    if min(tile) < 1:
        raise ValueError(f"the tile must be >= 1 cell a side, got {tile}")
    if dim == 2:
        return
    if dim == 3 and any(n + 2 * halo > w
                        for n, w in zip(tile, MULTI3D_WINDOW)):
        raise ValueError(
            f"tile {tile} with its {halo}-cell apron needs "
            f"{multi3d_threads(tile, halo)} threads, {MULTI3D_ROWS} window "
            f"rows of one column a thread; a block holds a window of at "
            f"most {MULTI3D_WINDOW[0]} x {MULTI3D_WINDOW[1]} cells, "
            f"{MULTI3D_MAX_THREADS} threads"
        )
    smem = multi_smem(dim, tile, halo)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"tile {tile} with its {halo}-cell halo needs {smem} bytes of "
            f"shared memory; a block has {MAX_SMEM_BYTES}"
        )


def launch_multi(symbol: str, u: torch.Tensor, out: torch.Tensor, bc: str,
                 t_steps: int, tile: tuple[int, ...]) -> int:
    """Launch a temporal-blocking kernel of ``csrc/multi.cu``: ``t_steps``
    fused steps of ``u`` into ``out`` (validate both with
    :func:`check_kernel_args` first); ``tile`` is a block's output tile
    (elements in 1D; rows, columns in 2D). Beyond ``MULTI_T_MAX`` steps
    the pass is chained: a launch from ``u`` into an f32 scratch field,
    launches between two f32 fields, and one from f32 into ``out``, so the
    field is narrowed once, as in a single launch. ``tile`` is rows,
    columns in 3D too (the kernel marches z), cut to what a block holds
    by :func:`multi3d_block_tile`. Returns the number of launches."""
    steps = multi_passes(t_steps, MULTI_T_MAX[u.dim()])
    halo = max(steps)
    if u.dim() == 3:
        tile = multi3d_block_tile(tile, halo, u.shape[1:])
    check_multi_tile(u.dim(), tile, halo)
    if u.dim() > 1 and -(-u.shape[-2] // tile[0]) > MAX_GRID_Y:
        raise ValueError(
            f"{u.shape[-2]} rows need tiles of more than {tile[0]} rows "
            f"(at most {MAX_GRID_Y} tiles down the field)"
        )
    scratch = [torch.empty(u.shape, dtype=torch.float32, device=u.device)
               for _ in range(min(len(steps) - 1, 2))]
    src = u
    for i, t in enumerate(steps):
        dst = out if i == len(steps) - 1 else scratch[i % 2]
        launch_kernel(
            symbol, u, src.data_ptr(), dst.data_ptr(), *u.shape,
            KERNEL_DTYPE_CODES[src.dtype], KERNEL_DTYPE_CODES[dst.dtype],
            int(bc == "periodic"), *tile, t,
        )
        src = dst
    return len(steps)


def from_numpy_field(
    u: np.ndarray, device, dtype: torch.dtype | None = None
) -> torch.Tensor:
    """A NumPy field as a tensor on ``device``, converted to ``dtype``
    (default: ``u``'s own). NumPy has no bfloat16, so a bf16 field comes
    from float32 values, rounded to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(u)).to(device)
    return t if dtype is None else t.to(dtype)


def to_numpy_field(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`from_numpy_field`: a host NumPy copy, bfloat16
    widened (exactly) to float32."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The NumPy dtype a field of ``dtype`` lives in on the host (float32
    for bfloat16, which NumPy lacks)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return np.dtype(str(dtype).removeprefix("torch."))
