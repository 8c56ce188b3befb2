#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_comm_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. environment: torch/CUDA versions, device count, ``nvidia-smi`` name and
   power limit;
2. build: the CUDA kernels from ``tpu_comm_torch/csrc`` into
   ``build/torch_ext/`` (timed);
3. every kernel x {float32, bfloat16, float16} x {dirichlet, periodic}:
   20 steps at full size through the kernel and through its plain
   PyTorch version on the card, required bitwise equal (``torch.equal``),
   plus ragged shapes and a non-default chunk;
4. the main path: ``python -m tpu_comm_torch stencil --impl auto --verify``
   (in process, through ``cli.main``) for dims 1, 2 and 3 at full size,
   each with every kernel's launch count set to 0 just before and read
   just after; each row must say ``platform: cuda`` and ``verified: true``
   and the dim's kernel must have launched;
5. times at the full float32 sizes (CUDA events): kernel, plain version,
   one library call computing the same stencil (``nn.Conv{1,2,3}d`` with
   circular padding, TF32 off; a yardstick the port never calls), and a
   device-to-device copy of the field;
6. the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
   line.

Full sizes: 1D 2^26 points, 2D 8192^2, 3D 512^3; in float32 that is
256/256/512 MiB per buffer, far above the 50 MB L2, so the kernels stream
DRAM. Fields are made on the card from fixed seeds.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIZES = {1: 1 << 26, 2: 8192, 3: 512}
CHECK_STEPS = 20
VERIFY_ITERS = 4
#: H100 SXM HBM3 rate (NVIDIA data sheet), the bytes bound's denominator
PEAK_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12
#: per output element: the adds and the one multiply of the update
OPS_PER_POINT = {1: 2, 2: 4, 3: 6}
KERNELS = {
    1: ("jacobi1d_stream", "tpu_comm/kernels/jacobi1d.py:318"),
    2: ("jacobi2d_stream", "tpu_comm/kernels/jacobi2d.py:293"),
    3: ("jacobi3d_stream", "tpu_comm/kernels/jacobi3d.py:153"),
}
SOURCE = "tpu_comm_torch/csrc/jacobi_stream.cu"
RAGGED = {
    1: [(3,), (1000001,)],
    2: [(3, 3), (37, 301), (1001, 37)],
    3: [(3, 3, 3), (19, 23, 45), (130, 9, 33)],
}
#: a non-default chunk per dim (rows / rows / planes), results must not move
ODD_CHUNK = {1: 1, 2: 5, 3: 3}
T0 = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps(obj, sort_keys=True), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def random_field(torch, shape, dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.rand(shape, generator=g, device="cuda", dtype=torch.float32)
    return u.to(dtype)


def time_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` by CUDA events over ``reps``
    back-to-back calls, after a warmup."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(torch, mods) -> dict:
    """Phase 3: kernel vs plain version, bitwise; returns the max abs
    error per dim (0.0 when every case was equal)."""
    from tpu_comm_torch.kernels import run_steps

    errs = {}
    for dim, mod in mods.items():
        cases = [(SIZES[dim],) * dim] + RAGGED[dim]
        worst = 0.0
        for shape in cases:
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                for bc in ("dirichlet", "periodic"):
                    u = random_field(torch, shape, dtype, seed=dim)
                    got = mod.run(u, CHECK_STEPS, bc=bc)
                    want = run_steps(mod.step_plain, u, CHECK_STEPS, bc)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    worst = max(worst, err)
                    if not torch.equal(got, want) or got.dtype != dtype:
                        fail(f"{KERNELS[dim][0]} {shape} {dtype} {bc}: "
                             f"kernel != plain (max abs err {err})")
                    if shape == cases[0] and bc == "periodic":
                        key = "planes_per_chunk" if dim == 3 else \
                            "rows_per_chunk"
                        odd = mod.run(u, 2, bc=bc, **{key: ODD_CHUNK[dim]})
                        if not torch.equal(odd, mod.run(u, 2, bc=bc)):
                            fail(f"{KERNELS[dim][0]}: result depends on "
                                 f"the chunk")
                    del u, got, want
        errs[dim] = worst
        emit({"check": {"kernel": KERNELS[dim][0], "shapes": cases,
                        "steps": CHECK_STEPS, "max_abs_err": worst,
                        "tolerance": "bitwise (torch.equal)",
                        "elapsed_s": time.perf_counter() - T0}})
    return errs


def drive_main_path(torch, mods) -> dict:
    """Phase 4: the driver at full size per dim; returns the dim's
    kernel launches in its run."""
    from tpu_comm_torch import cli

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dim, mod in mods.items():
            path = Path(tmp) / f"stencil{dim}d.jsonl"
            for m in mods.values():
                m.step_stream.launches = 0
            rc = cli.main([
                "stencil", "--dim", str(dim), "--size", str(SIZES[dim]),
                "--impl", "auto", "--verify",
                "--verify-iters", str(VERIFY_ITERS), "--jsonl", str(path),
            ])
            counts = {d: m.step_stream.launches for d, m in mods.items()}
            if rc != 0:
                fail(f"stencil --dim {dim} exited {rc}")
            row = json.loads(path.read_text().splitlines()[-1])
            platform, verified = row.get("platform"), row.get("verified")
            if platform != "cuda" or verified is not True:
                fail(f"stencil --dim {dim}: row says platform={platform} "
                     f"verified={verified}")
            if row.get("impl") != "stream":
                fail(f"stencil --dim {dim}: auto gave {row.get('impl')}")
            if counts[dim] == 0:
                fail(f"{KERNELS[dim][0]} was not launched on the main path")
            if any(c for d, c in counts.items() if d != dim):
                fail(f"stencil --dim {dim} launched other kernels: {counts}")
            launches[dim] = counts[dim]
            emit({"main_path": {"dim": dim, "launches": counts[dim],
                                "gbps_eff": row["gbps_eff"],
                                "secs_per_iter": row["secs_per_iter"],
                                "elapsed_s": time.perf_counter() - T0}})
    return launches


def library_call(torch, dim: int):
    """One PyTorch call computing the periodic stencil: a circular-padded
    convolution with the stencil's weights."""
    conv = {1: torch.nn.Conv1d, 2: torch.nn.Conv2d, 3: torch.nn.Conv3d}[dim](
        1, 1, 3, padding=1, padding_mode="circular", bias=False,
    ).cuda()
    w = torch.zeros((1, 1) + (3,) * dim, device="cuda")
    for axis in range(dim):
        for side in (0, 2):
            idx = [0, 0] + [1] * dim
            idx[2 + axis] = side
            w[tuple(idx)] = 1.0 / (2 * dim)
    with torch.no_grad():
        conv.weight.copy_(w)
    return conv


def measure_times(torch, mods) -> dict:
    """Phase 5: per-step times at the full float32 sizes."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dim, mod in mods.items():
        shape = (SIZES[dim],) * dim
        u = random_field(torch, shape, torch.float32, seed=10 + dim)
        dst = torch.empty_like(u)
        n = u.numel()
        mod.step_stream.launches = 0
        mod.run(u, 100, bc="dirichlet")
        per_run = mod.step_stream.launches
        kernel_ms = time_ms(
            torch, lambda: mod.step_stream(u, "dirichlet", out=dst), 50)
        plain_ms = time_ms(
            torch, lambda: mod.step_plain(u, "dirichlet", out=dst), 10)
        copy_ms = time_ms(torch, lambda: dst.copy_(u), 50)
        conv = library_call(torch, dim)
        x = u.reshape((1, 1) + shape)
        with torch.no_grad():
            library_ms = time_ms(torch, lambda: conv(x), 10)
            lib_err = float(
                (conv(x).reshape(shape) - mod.step_plain(u, "periodic"))
                .abs().max()
            )
        nbytes = 2 * n * u.element_size()
        ops = OPS_PER_POINT[dim] * n
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
        out[dim] = {
            "kernel": KERNELS[dim][0], "shape": list(shape),
            "dtype": "float32", "bc": "dirichlet",
            "kernel_ms": kernel_ms, "launches_per_run": per_run,
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": f"torch.nn.Conv{dim}d(padding_mode='circular')",
            "library_max_abs_err": lib_err,
            "copy_ms": copy_ms,
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # the repo's own roofline rule: the same bytes at the measured
            # copy's rate, which is the copy's own time
            "copy_bound_ms": copy_ms,
        }
        emit({"times": {**out[dim], "elapsed_s": time.perf_counter() - T0}})
        del u, dst, x, conv
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script needs one GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpu_comm_torch.bench.timing import nvidia_smi_line
    from tpu_comm_torch.kernels import _build, stencil_module

    smi = nvidia_smi_line()
    if smi is None:
        fail("nvidia-smi gave no name and power limit")
    emit({"environment": {
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device_count": torch.cuda.device_count(),
        "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
    }})
    print(smi, flush=True)

    t0 = time.perf_counter()
    libs = _build.libraries()
    emit({"build": {"seconds": time.perf_counter() - t0,
                    "libraries": sorted(libs),
                    "build_dir": str(_build.BUILD_DIR.relative_to(ROOT))}})

    mods = {dim: stencil_module(dim) for dim in (1, 2, 3)}
    errs = check_kernels(torch, mods)
    launches = drive_main_path(torch, mods)
    times = measure_times(torch, mods)

    print(smi, flush=True)
    emit({"kernels": [
        {
            "name": KERNELS[dim][0], "route": "cuda", "source": SOURCE,
            "replaces": KERNELS[dim][1], "launches": launches[dim],
            "max_abs_err": errs[dim], "ms": times[dim]["kernel_ms"],
            "plain_ms": times[dim]["plain_ms"],
            "bound_ms": times[dim]["bound_ms"],
            "bound_by": times[dim]["bound_by"],
            "library_ms": times[dim]["library_ms"],
            "copy_ms": times[dim]["copy_ms"],
            "shape": times[dim]["shape"], "dtype": "float32",
        }
        for dim in (1, 2, 3)
    ]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
