"""The stencil kernels' dtype contract and the field's host/device form.

Port of the dtype half of ``tpu_comm/kernels/tiling.py``
(``f32_compute``, ``narrow_store``, ``check_pallas_dtype``). Every kernel
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

import numpy as np
import torch

#: field dtypes the stencil kernels take, by the driver's ``--dtype`` name
DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
#: dtype codes of the CUDA launchers (kFloat32/kBFloat16/kFloat16 in
#: csrc/jacobi_stream.cu)
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
    u: torch.Tensor, ndim: int, out: torch.Tensor | None
) -> torch.Tensor:
    """Validate a CUDA kernel's input; return ``out`` (allocated with
    ``torch.empty_like`` when None). Raises on what the kernels do not
    take: another device, dtype, rank, a non-contiguous tensor, an extent
    below 3, or an output that aliases the input or differs in form."""
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
    if min(u.shape) < 3:
        raise ValueError(f"every extent must be >= 3, got {tuple(u.shape)}")
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


def launch_stencil(symbol: str, u: torch.Tensor, out: torch.Tensor, bc: str,
                   chunk: int) -> None:
    """Launch a stencil kernel of ``csrc/`` on ``u``'s device and current
    stream. Every launcher takes ``(u, out, *extents, dtype code,
    periodic, chunk, stream)``; validate ``u`` and ``out`` with
    :func:`check_kernel_args` first."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    from tpu_comm_torch.kernels._build import launch

    with torch.cuda.device(u.device):
        launch(
            symbol, u.data_ptr(), out.data_ptr(), *u.shape,
            KERNEL_DTYPE_CODES[u.dtype], int(bc == "periodic"), chunk,
            torch.cuda.current_stream(u.device).cuda_stream,
        )


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
