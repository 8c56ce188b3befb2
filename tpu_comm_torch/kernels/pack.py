"""Face pack of a 3D block: plain PyTorch version + hand-written CUDA
kernel (port of ``tpu_comm/kernels/pack.py``).

A halo exchange sends each boundary face of a block ``u[nz, ny, nx]`` as
a contiguous buffer. The z faces are contiguous slabs already; the y
faces are one row per slab and the x faces one element per row, so they
are gathered first:

    z_lo/z_hi : (ny, nx)  — ``u[0]``, ``u[nz-1]`` (views, nothing to pack)
    y_lo/y_hi : (nz, nx)  — a row per slab
    x_lo/x_hi : (nz, ny)  — a column per slab (the strided one)

- ``pack_faces_plain`` — the four strided faces by slice copies; what the
  CPU runs.
- ``pack_faces``       — the wrapper of ``pack_faces_kernel`` in
  ``csrc/pack.cu`` (the port of ``_pack_kernel`` /
  ``pack_faces_3d_pallas``): one launch writes all four faces, on the
  grid of :func:`pack_plan`. A CUDA tensor goes to the kernel, a CPU
  tensor to ``pack_faces_plain``.
- ``pack_faces_3d``    — all six faces by either arm: ``fused`` (views of
  the block; JAX's ``lax`` arm, which XLA fuses into the collective) or
  ``kernel`` (JAX's ``pallas`` arm).
"""

from __future__ import annotations

import functools

import torch

from tpu_comm_torch.kernels.tiling import KERNEL_DTYPE_CODES, launch_kernel

FACE_NAMES = ("z_lo", "z_hi", "y_lo", "y_hi", "x_lo", "x_hi")
#: pack arms of the distributed step (JAX: ``fused`` and ``pallas``)
PACK_IMPLS = ("fused", "kernel")
#: threads a block of the kernel (``csrc/pack.cu`` kThreads)
PACK_THREADS = 256
#: blocks an SM the grid holds at most; beyond, warps stride over items
#: (the fastest of 1-16 on the H100, PERF.md §6)
BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=256)
def pack_plan(shape: tuple, sms: int) -> int:
    """The blocks of ``pack_faces_kernel``'s grid for a block of ``shape``
    (nz, ny, nx) on a card of ``sms`` SMs: a warp for each work item (an
    x chunk of 32 flat rows, or one of the 2 nz y rows), at most
    BLOCKS_PER_SM blocks an SM, whose warps then stride over the rest."""
    if sms < 1:
        raise ValueError(f"need sms >= 1, got {sms}")
    nz, ny, _ = shape
    items = -(-nz * ny // 32) + 2 * nz
    return min(-(-items // (PACK_THREADS // 32)), sms * BLOCKS_PER_SM)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _face_buffers(u: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The four packed faces' storage: one allocation, four contiguous
    views ``y_lo, y_hi (nz, nx)``, ``x_lo, x_hi (nz, ny)`` (each made by
    one ``as_strided``: the fewest tensor ops, as the wrapper's host time
    a call is several times the kernel's)."""
    nz, ny, nx = u.shape
    buf = u.new_empty(2 * nz * (nx + ny))
    y, x = nz * nx, nz * ny
    return (buf.as_strided((nz, nx), (nx, 1), 0),
            buf.as_strided((nz, nx), (nx, 1), y),
            buf.as_strided((nz, ny), (ny, 1), 2 * y),
            buf.as_strided((nz, ny), (ny, 1), 2 * y + x))


def _check_block(u: torch.Tensor) -> None:
    if u.dim() != 3:
        raise ValueError(f"expected a 3-D block, got shape {tuple(u.shape)}")
    if min(u.shape) < 1:
        raise ValueError(f"every extent must be >= 1, got {tuple(u.shape)}")


def pack_faces_plain(u: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``(y_lo, y_hi, x_lo, x_hi)`` as contiguous copies, in plain
    PyTorch."""
    _check_block(u)
    faces = _face_buffers(u)
    for face, src in zip(
        faces, (u[:, 0, :], u[:, -1, :], u[:, :, 0], u[:, :, -1])
    ):
        face.copy_(src)
    return faces


def pack_faces(u: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``(y_lo, y_hi, x_lo, x_hi)`` as contiguous copies: the CUDA kernel
    for a CUDA tensor, ``pack_faces_plain`` for a CPU tensor.
    ``pack_faces.launches`` counts kernel launches."""
    _check_block(u)
    if not u.is_cuda:
        if u.device.type == "cpu":
            return pack_faces_plain(u)
        raise ValueError(f"CUDA kernel needs a CUDA tensor, got {u.device}")
    if u.dtype not in KERNEL_DTYPE_CODES:
        raise ValueError(
            f"CUDA kernel takes {tuple(KERNEL_DTYPE_CODES)}, got {u.dtype}"
        )
    if not u.is_contiguous():
        raise ValueError("CUDA kernel needs a contiguous block")
    shape = tuple(u.shape)
    blocks = pack_plan(shape, _sms(u.get_device()))
    faces = _face_buffers(u)
    launch_kernel(
        "tc_pack_faces", u, u.data_ptr(), *(f.data_ptr() for f in faces),
        *shape, u.element_size(), blocks,
    )
    pack_faces.launches += 1
    return faces


pack_faces.launches = 0


def pack_faces_3d(u: torch.Tensor, impl: str = "fused"
                  ) -> tuple[torch.Tensor, ...]:
    """The six width-1 boundary faces of ``u`` in :data:`FACE_NAMES`
    order. ``fused``: views of the block (whoever sends one makes it
    contiguous). ``kernel``: the z faces as views, the four strided
    faces from one :func:`pack_faces` pass."""
    _check_block(u)
    if impl == "fused":
        return (u[0], u[-1], u[:, 0, :], u[:, -1, :], u[:, :, 0],
                u[:, :, -1])
    if impl == "kernel":
        return (u[0], u[-1], *pack_faces(u))
    raise ValueError(f"unknown pack impl {impl!r} (fused|kernel)")
