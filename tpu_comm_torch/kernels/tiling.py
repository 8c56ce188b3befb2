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

import numpy as np
import torch

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
    ``args`` and, last, the device's current stream."""
    from tpu_comm_torch.kernels._build import launch

    with torch.cuda.device(t.device):
        launch(symbol, *args, torch.cuda.current_stream(t.device).cuda_stream)


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
