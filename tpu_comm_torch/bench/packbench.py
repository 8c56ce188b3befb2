"""Face-pack microbenchmark (port of ``tpu_comm/bench/packbench.py``):
the face-pack kernel against slice copies of the faces, on a 3D block.

Both arms produce the six contiguous face buffers of a block
``u[nz, ny, nx]``, as a halo exchange sends them (``kernels/pack.py``
``pack_faces_3d``); the z faces are contiguous slabs of the block, views
in both arms:

- ``fused``  (JAX ``lax``)    — the four strided faces (the y rows and
  the x columns) by slice copies, one copy a face.
- ``kernel`` (JAX ``pallas``) — the four strided faces by one launch of
  the face-pack kernel (``csrc/pack.cu`` ``pack_faces_kernel``).

JAX times a compiled loop of packs, one dispatch (an
``optimization_barrier`` keeps every face materialized and a one-element
dependency keeps the pack in the loop). Eager PyTorch neither elides nor
hoists a copy, so the port's loop is ``iters`` packs; on the card it is
one replay of a CUDA graph of them (``kernels/graphs.py``), captured
once a loop length, so a row times the card, not the host's launches.

Metrics: ``secs_per_iter`` and ``gbps_faces`` (face payload / time)
compare the arms on identical work; ``gbps_eff`` rates each arm against
JAX's traffic model (:func:`pack_bytes_per_iter`), kept as it is so the
rows of both packages compare. That model is the TPU's: its Pallas kernel
streams the whole block. The port's kernel reads only the face rows and,
for the x faces, one DRAM sector a row, so its ``gbps_eff`` counts bytes
the H100 does not move; ``gbps_faces`` is the figure to compare.

Not ported: ``--chunk`` and ``--dimsem`` (the Pallas kernel's y-block and
grid semantics; the port's kernel takes its grid from ``pack_plan``), the
tuned-table lookup and the obs byte counter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_comm_torch.bench.timing import emit_jsonl, time_loop_per_iter
from tpu_comm_torch.kernels import pack as packmod
from tpu_comm_torch.kernels.tiling import (
    from_numpy_field,
    numpy_dtype,
    torch_dtype,
)

#: the port's pack arms
PACK_IMPLS = ("fused", "kernel")
#: the JAX package's pack arm name -> the port's
JAX_PACK_IMPLS = {"lax": "fused", "pallas": "kernel"}


@dataclass
class PackConfig:
    nz: int = 128
    ny: int = 128
    nx: int = 512
    impl: str = "kernel"   # fused | kernel
    backend: str = "cuda"
    dtype: str = "float32"
    iters: int = 20
    warmup: int = 2
    reps: int = 5
    verify: bool = True
    jsonl: str | None = None


def face_bytes(nz: int, ny: int, nx: int, itemsize: int) -> int:
    """Payload of one pack: the six face buffers (what both arms emit)."""
    return 2 * (ny * nx + nz * nx + nz * ny) * itemsize


def pack_bytes_per_iter(
    nz: int, ny: int, nx: int, itemsize: int, impl: str = "kernel"
) -> int:
    """JAX's per-arm traffic model of one pack pass: ``kernel`` the
    volume read plus the face writes (the TPU kernel streams the block),
    ``fused`` the face reads plus writes."""
    faces = face_bytes(nz, ny, nx, itemsize)
    if impl == "kernel":
        return nz * ny * nx * itemsize + faces
    return 2 * faces


def check_impl(impl: str) -> None:
    """ValueError for an arm the port does not have; a JAX arm name is
    answered with the port's name for it."""
    if impl in PACK_IMPLS:
        return
    if impl in JAX_PACK_IMPLS:
        raise ValueError(
            f"--impl {impl} is the JAX package's name; the port calls this "
            f"arm {JAX_PACK_IMPLS[impl]!r}"
        )
    raise ValueError(f"impl must be one of {PACK_IMPLS}, got {impl!r}")


def pack_once(u: torch.Tensor, impl: str) -> tuple[torch.Tensor, ...]:
    """The six faces of ``u`` as contiguous buffers, by the arm ``impl``:
    the z faces as views, the four strided faces copied (``fused``) or
    packed by the kernel (``kernel``)."""
    faces = packmod.pack_faces_3d(u, impl)
    if impl == "fused":
        return tuple(f.contiguous() for f in faces)
    return faces


def _loop(u: torch.Tensor, impl: str, k: int):
    """``k`` packs of ``u``; returns the last pack's y_lo face."""
    faces = None
    for _ in range(k):
        faces = pack_once(u, impl)
    return faces[2]


def run_pack_bench(cfg: PackConfig) -> dict:
    from tpu_comm_torch.kernels.graphs import Graph
    from tpu_comm_torch.topo import get_device

    check_impl(cfg.impl)
    dtype = torch_dtype(cfg.dtype)
    if min(cfg.nz, cfg.ny, cfg.nx) < 1:
        raise ValueError(
            f"every extent must be >= 1, got {(cfg.nz, cfg.ny, cfg.nx)}"
        )
    if cfg.iters < 1:
        raise ValueError(f"--iters must be >= 1, got {cfg.iters}")
    device = get_device(cfg.backend)
    rng = np.random.default_rng(0)
    host = rng.standard_normal((cfg.nz, cfg.ny, cfg.nx)).astype(
        numpy_dtype(dtype))
    u = from_numpy_field(host, device, dtype)

    if cfg.verify:
        got = pack_once(u, cfg.impl)
        want = (u[0], u[-1], u[:, 0, :], u[:, -1, :], u[:, :, 0],
                u[:, :, -1])
        for name, g, w in zip(packmod.FACE_NAMES, got, want):
            if not g.is_contiguous() or not torch.equal(g, w):
                raise AssertionError(f"pack verification FAILED: face {name}")

    graphs: dict[int, Graph] = {}
    outs: dict[int, torch.Tensor] = {}

    def run_iters(k: int):
        if device.type != "cuda":
            return _loop(u, cfg.impl, k)
        if k not in graphs:
            def body():
                outs[k] = _loop(u, cfg.impl, k)
            graphs[k] = Graph(body)
        graphs[k].dispatch()
        return outs[k]

    try:
        per_iter, t_lo, _ = time_loop_per_iter(
            run_iters, cfg.iters, warmup=cfg.warmup, reps=cfg.reps,
        )
    finally:
        for g in graphs.values():
            g.release()
    resolved = per_iter > 1e-9
    nbytes = pack_bytes_per_iter(cfg.nz, cfg.ny, cfg.nx, dtype.itemsize,
                                 impl=cfg.impl)
    fbytes = face_bytes(cfg.nz, cfg.ny, cfg.nx, dtype.itemsize)
    record = {
        "workload": f"pack3d-{cfg.impl}",
        "impl": cfg.impl,
        "backend": cfg.backend,
        "platform": device.type,
        "mesh": [1],
        "dtype": cfg.dtype,
        "size": [cfg.nz, cfg.ny, cfg.nx],
        "iters": cfg.iters,
        "dispatch": "graph" if device.type == "cuda" else "eager",
        "secs_per_iter": per_iter,
        "bytes_per_iter": nbytes,
        "gbps_eff": (nbytes / per_iter / 1e9) if resolved else None,
        "gbps_faces": (fbytes / per_iter / 1e9) if resolved else None,
        "interpret_mode": False,
        "below_timing_resolution": not resolved,
        "verified": bool(cfg.verify),
        **t_lo.phase_fields(),
        **{f"t_{k}": v for k, v in t_lo.summary().items()},
    }
    if cfg.jsonl:
        emit_jsonl(record, cfg.jsonl)
    return record
