#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_comm_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. environment: torch/CUDA versions, device count, ``nvidia-smi`` name and
   power limit;
2. build: the CUDA kernels from ``tpu_comm_torch/csrc`` into
   ``build/torch_ext/`` (one ``nvcc`` per source, all at once; timed);
3. every kernel against its plain PyTorch version on the card, required
   bitwise equal (``torch.equal``):
   - stencils, the stream and the block kernels: kernel x {float32,
     bfloat16, float16} x {dirichlet, periodic}, 20 steps at full size,
     plus ragged shapes and (stream) a non-default chunk;
   - the face pack: the four packed faces x every dtype at 512^3 and at
     ragged shapes;
   - membw: every op a kernel serves x every dtype x aliased on/off x the
     default and a non-default chunk, at 2^26 elements and at a ragged
     size; the dma copy at depths 2, 3 and 4, also with fewer chunks per
     CTA than slots; and the stream kernel's machine code must still hold
     its neighbour loads (``cuobjdump``);
4. the main path, in process through ``cli.main``, each run with every
   kernel's launch count set to 0 just before and read just after:
   ``stencil --impl auto --verify`` for dims 1, 2 and 3 at full size,
   ``membw --op OP --impl ARM`` for every (op, arm) pair the JAX CLI
   accepts, and the mesh runs ``stencil --mesh 1[,1[,1]]`` (world size 1,
   the NCCL group created; a periodic axis exchanges with its own rank
   through NCCL) for the block arm in 1D, 2D and 3D and the stream,
   overlap and auto arms in 3D, the 3D ones with ``--pack kernel``, each
   dirichlet and periodic, plus one ``--tol`` run whose residual goes
   through ``all_reduce``; each row must say ``platform: cuda`` and
   ``verified: true``, the run's kernels must have launched and no other;
5. times at the full float32 sizes (CUDA events): kernel, plain version,
   one library call computing the same function (a yardstick the port
   never calls), and for each stencil a device-to-device ``copy_`` and the
   port's own chunked copy kernel at the same bytes; and per 3D mesh arm
   the whole distributed step (exchange, kernel, face recompute, freeze)
   beside its kernel alone;
6. the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
   line.

Full sizes: stencils 1D 2^26 points, 2D 8192^2, 3D 512^3; membw 2^26
elements. In float32 that is 256/256/512 MiB per buffer, far above the
50 MB L2, so the kernels stream DRAM. Inputs are made on the card from
fixed seeds.
"""

from __future__ import annotations

import json
import subprocess
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
#: stencil arm -> dim -> (kernel, the TPU kernel body it replaces)
KERNELS = {
    "stream": {
        1: ("jacobi1d_stream", "tpu_comm/kernels/jacobi1d.py:318"),
        2: ("jacobi2d_stream", "tpu_comm/kernels/jacobi2d.py:293"),
        3: ("jacobi3d_stream", "tpu_comm/kernels/jacobi3d.py:153"),
    },
    "block": {
        1: ("jacobi1d_block", "tpu_comm/kernels/jacobi1d.py:139"),
        2: ("jacobi2d_block", "tpu_comm/kernels/jacobi2d.py:147"),
        3: ("jacobi3d_block", "tpu_comm/kernels/jacobi3d.py:108"),
    },
}
SOURCES = {"stream": "tpu_comm_torch/csrc/jacobi_stream.cu",
           "block": "tpu_comm_torch/csrc/jacobi_block.cu"}
PACK_KERNEL = ("pack_faces", "tpu_comm/kernels/pack.py:48")
PACK_SOURCE = "tpu_comm_torch/csrc/pack.cu"
PACK_RAGGED = [(1, 1, 1), (3, 5, 7), (19, 23, 45), (130, 9, 33)]
#: DRAM sector: what one x-face element costs to read (one per row of nx)
SECTOR_BYTES = 32
#: the mesh runs of phase 4: (dim, --impl, --pack), each in both bc
MESH_RUNS = [(1, "block", "fused"), (2, "block", "fused"),
             (3, "block", "kernel"), (3, "stream", "kernel"),
             (3, "overlap", "kernel"), (3, "auto", "fused")]
#: loop lengths of a mesh run (the eager face work makes a step long)
MESH_ITERS = 20
RAGGED = {
    1: [(3,), (1000001,)],
    2: [(3, 3), (37, 301), (1001, 37)],
    3: [(3, 3, 3), (19, 23, 45), (130, 9, 33)],
}
#: a non-default chunk per dim (rows / rows / planes), results must not move
ODD_CHUNK = {1: 1, 2: 5, 3: 3}
MEMBW_N = 1 << 26
#: 25 rows of 128: the last chunk of 8 rows is ragged
MEMBW_RAGGED = 128 * 8 * 3 + 128
MEMBW_ODD_CHUNK = 3
MEMBW_SOURCE = "tpu_comm_torch/csrc/membw.cu"
#: the scalar of the checks: not representable in any field dtype, so the
#: kernels' narrow-then-widen of s is exercised
MEMBW_S = 0.7
#: kernel -> the TPU body it replaces, the ops it serves, and the op whose
#: time the kernels line carries
MEMBW_KERNELS = {
    "membw_unary": ("tpu_comm/bench/membw.py:89", ("copy", "scale"), "copy"),
    "membw_binary": ("tpu_comm/bench/membw.py:98", ("add", "triad"),
                     "triad"),
    "membw_stream": ("tpu_comm/bench/membw.py:150", ("copy",), "copy"),
    "membw_dma": ("tpu_comm/bench/membw.py:198", ("copy",), "copy"),
}
#: every (op, --impl) pair the JAX CLI accepts, in the port's arm names
MEMBW_RUNS = [(op, arm) for op in ("copy", "scale", "add", "triad")
              for arm in ("torch", "chunked", "both")] + [
    ("copy", "stream"), ("copy", "dma")]
#: the wrapper whose count an arm's run must raise (the torch arm runs no
#: kernel of the port)
MEMBW_WRAPPER = {"chunked": "membw.step_chunked", "both": "membw.step_chunked",
                 "stream": "membw.step_stream", "dma": "membw.step_dma"}
#: operations per element of each op (its bound's second term)
MEMBW_OPS_PER_ELEM = {"copy": 0, "scale": 1, "add": 1, "triad": 2}
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


def queued_ms(torch, fn, reps: int, filler) -> tuple[float, bool]:
    """Device milliseconds per call of a short ``fn`` whose back-to-back
    calls would be paced by the host: the calls are queued behind
    ``filler()``, device work long enough for the host to enqueue them
    all, so they run on the card without gaps. Returns the time and
    whether the host did finish enqueueing before the filler ended."""
    fn()
    torch.cuda.synchronize()
    fill_end = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    filler()
    fill_end.record()
    start.record()
    for _ in range(reps):
        fn()
    queued = not fill_end.query()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, queued


def check_kernels(torch, mods, arm: str) -> dict:
    """Phase 3: the ``arm`` kernel of each dim vs the plain version,
    bitwise; returns the max abs error per dim (0.0 when every case was
    equal)."""
    from tpu_comm_torch.kernels import run_steps

    errs = {}
    for dim, mod in mods.items():
        name = KERNELS[arm][dim][0]
        cases = [(SIZES[dim],) * dim] + RAGGED[dim]
        if arm == "block" and dim == 3:
            cases = cases + [(2, 3, 3)]  # the plane kernel's least depth
        worst = 0.0
        for shape in cases:
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                for bc in ("dirichlet", "periodic"):
                    u = random_field(torch, shape, dtype, seed=dim)
                    got = mod.run(u, CHECK_STEPS, bc=bc, impl=arm)
                    want = run_steps(mod.step_plain, u, CHECK_STEPS, bc)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    worst = max(worst, err)
                    if not torch.equal(got, want) or got.dtype != dtype:
                        fail(f"{name} {shape} {dtype} {bc}: "
                             f"kernel != plain (max abs err {err})")
                    if (arm == "stream" and shape == cases[0]
                            and bc == "periodic"):
                        key = "planes_per_chunk" if dim == 3 else \
                            "rows_per_chunk"
                        odd = mod.run(u, 2, bc=bc, **{key: ODD_CHUNK[dim]})
                        if not torch.equal(odd, mod.run(u, 2, bc=bc)):
                            fail(f"{name}: result depends on the chunk")
                    del u, got, want
        errs[dim] = worst
        emit({"check": {"kernel": name, "shapes": cases,
                        "steps": CHECK_STEPS, "max_abs_err": worst,
                        "tolerance": "bitwise (torch.equal)",
                        "elapsed_s": time.perf_counter() - T0}})
    return errs


def check_pack(torch) -> float:
    """Phase 3, face pack: the kernel's four faces vs the plain version,
    bitwise; returns the max abs error (0.0 when every case was equal)."""
    from tpu_comm_torch.kernels import pack

    worst = 0.0
    cases = [(SIZES[3],) * 3] + PACK_RAGGED
    for shape in cases:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            u = random_field(torch, shape, dtype, seed=40)
            got, want = pack.pack_faces(u), pack.pack_faces_plain(u)
            torch.cuda.synchronize()
            for name, g, w in zip(pack.FACE_NAMES[2:], got, want):
                err = float((g.float() - w.float()).abs().max())
                worst = max(worst, err)
                if g.dtype != dtype or not torch.equal(g, w):
                    fail(f"pack_faces {shape} {dtype} {name}: kernel != "
                         f"plain (max abs err {err})")
            del u, got, want
    emit({"check": {"kernel": PACK_KERNEL[0], "shapes": cases,
                    "max_abs_err": worst,
                    "tolerance": "bitwise (torch.equal)",
                    "elapsed_s": time.perf_counter() - T0}})
    return worst


def drive_main_path(torch, mods, counters) -> dict:
    """Phase 4: the driver at full size per dim; returns the dim's
    kernel launches in its run."""
    from tpu_comm_torch import cli

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dim in mods:
            path = Path(tmp) / f"stencil{dim}d.jsonl"
            for w in counters.values():
                w.launches = 0
            rc = cli.main([
                "stencil", "--dim", str(dim), "--size", str(SIZES[dim]),
                "--impl", "auto", "--verify",
                "--verify-iters", str(VERIFY_ITERS), "--jsonl", str(path),
            ])
            counts = {k: w.launches for k, w in counters.items()}
            name = KERNELS["stream"][dim][0]
            if rc != 0:
                fail(f"stencil --dim {dim} exited {rc}")
            row = json.loads(path.read_text().splitlines()[-1])
            platform, verified = row.get("platform"), row.get("verified")
            if platform != "cuda" or verified is not True:
                fail(f"stencil --dim {dim}: row says platform={platform} "
                     f"verified={verified}")
            if row.get("impl") != "stream":
                fail(f"stencil --dim {dim}: auto gave {row.get('impl')}")
            if counts[name] == 0:
                fail(f"{name} was not launched on the main path")
            if any(c for k, c in counts.items() if k != name):
                fail(f"stencil --dim {dim} launched other kernels: {counts}")
            launches[dim] = counts[name]
            emit({"main_path": {"dim": dim, "launches": counts[name],
                                "gbps_eff": row["gbps_eff"],
                                "secs_per_iter": row["secs_per_iter"],
                                "elapsed_s": time.perf_counter() - T0}})
    return launches


def drive_mesh(torch, counters) -> dict:
    """Phase 4, the distributed stencil at world size 1: ``stencil --mesh
    1[,1[,1]]`` per (dim, arm, pack) and bc, and one ``--tol`` run; returns
    each kernel's launches summed over the runs."""
    from tpu_comm_torch import cli

    launches = {name: 0 for name in counters}
    runs = [(dim, impl, pack, bc, []) for dim, impl, pack in MESH_RUNS
            for bc in ("dirichlet", "periodic")]
    runs.append((2, "block", "fused", "dirichlet",
                 ["--tol", "1e-3", "--check-every", "4"]))
    with tempfile.TemporaryDirectory() as tmp:
        for n, (dim, impl, pack, bc, extra) in enumerate(runs):
            path = Path(tmp) / f"mesh{n}.jsonl"
            for w in counters.values():
                w.launches = 0
            argv = ["stencil", "--mesh", ",".join(["1"] * dim), "--dim",
                    str(dim), "--size", str(SIZES[dim]), "--impl", impl,
                    "--pack", pack, "--bc", bc, "--verify",
                    "--verify-iters", str(VERIFY_ITERS), "--iters",
                    str(8 if extra else MESH_ITERS), "--warmup", "2",
                    "--reps", "5", "--jsonl", str(path), *extra]
            rc = cli.main(argv)
            counts = {k: w.launches for k, w in counters.items()}
            what = " ".join(argv[1:-2] if not extra else argv[1:])
            if rc != 0:
                fail(f"{what} exited {rc}")
            row = json.loads(path.read_text().splitlines()[-1])
            arm = "overlap" if impl == "auto" else impl
            want = {"platform": "cuda", "verified": True, "impl": arm,
                    "pack": pack, "mesh": [1] * dim, "topo_plan": None,
                    "workload": f"stencil{dim}d-dist"
                    + ("-conv" if extra else "")}
            got = {k: row.get(k) for k in want}
            if got != want:
                fail(f"{what}: row says {got}, expected {want}")
            expected = set()
            if arm in KERNELS:
                expected.add(KERNELS[arm][dim][0])
            if pack == "kernel":
                expected.add(PACK_KERNEL[0])
            launched = {k for k, c in counts.items() if c}
            if launched != expected:
                fail(f"{what} launched {sorted(launched)}, expected "
                     f"{sorted(expected)}: {counts}")
            for k in expected:
                launches[k] += counts[k]
            emit({"main_path": {
                "mesh": [1] * dim, "impl": arm, "pack": pack, "bc": bc,
                "tol": bool(extra),
                "launches": {k: counts[k] for k in sorted(expected)},
                "gbps_eff": row["gbps_eff"], "iters": row["iters"],
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


def measure_times(torch, mods, arm: str) -> dict:
    """Phase 5: per-step times of the ``arm`` kernels at the full float32
    sizes."""
    from tpu_comm_torch.kernels import membw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dim, mod in mods.items():
        shape = (SIZES[dim],) * dim
        u = random_field(torch, shape, torch.float32, seed=10 + dim)
        dst = torch.empty_like(u)
        n = u.numel()
        step = mod.STEPS[arm]
        kernel_ms = time_ms(torch, lambda: step(u, "dirichlet", out=dst), 50)
        periodic_ms = time_ms(torch, lambda: step(u, "periodic", out=dst), 50)
        plain_ms = time_ms(
            torch, lambda: mod.step_plain(u, "dirichlet", out=dst), 10)
        copy_ms = time_ms(torch, lambda: dst.copy_(u), 50)
        flat_u, flat_dst = u.reshape(-1), dst.reshape(-1)
        chunked_copy_ms = time_ms(
            torch, lambda: membw.step_chunked(flat_u, None, 1.0, "copy",
                                              out=flat_dst), 50)
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
            "kernel": KERNELS[arm][dim][0], "shape": list(shape),
            "dtype": "float32", "bc": "dirichlet",
            "kernel_ms": kernel_ms, "kernel_periodic_ms": periodic_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": f"torch.nn.Conv{dim}d(padding_mode='circular')",
            "library_max_abs_err": lib_err,
            "copy_ms": copy_ms,
            # the repo's own roofline rule: the port's own measured copy
            # (membw_unary) at the same bytes, the denominator the JAX
            # package reads its stencil numbers against
            "chunked_copy_ms": chunked_copy_ms,
            "kernel_over_chunked_copy": kernel_ms / chunked_copy_ms,
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        emit({"times": {**out[dim], "elapsed_s": time.perf_counter() - T0}})
        del u, dst, x, conv, flat_u, flat_dst
        torch.cuda.empty_cache()
    return out


def measure_pack(torch) -> dict:
    """Phase 5, face pack at 512^3 float32: kernel, plain version, the
    four ``.contiguous()`` slices as the library yardstick and a
    ``copy_`` of the faces' bytes, all as device time (:func:`queued_ms`),
    and the wrapper's back-to-back call time."""
    from tpu_comm_torch.kernels import pack

    nz = ny = nx = SIZES[3]
    u = random_field(torch, (nz, ny, nx), torch.float32, seed=41)
    item = u.element_size()
    faces = (2 * nz * nx + 2 * nz * ny) * item
    copy_src = torch.empty(faces // item, device="cuda")
    copy_dst = torch.empty_like(copy_src)
    big = torch.empty_like(u)

    def filler():  # ~8 ms of copies: room to enqueue 20 short calls
        for _ in range(24):
            big.copy_(u)

    def library():
        return (u[:, 0, :].contiguous(), u[:, -1, :].contiguous(),
                u[:, :, 0].contiguous(), u[:, :, -1].contiguous())

    # the pack takes microseconds on the card, less than its Python call:
    # back-to-back calls time the host (call_ms), queued calls the card
    call_ms = time_ms(torch, lambda: pack.pack_faces(u), 50)
    timed = {
        name: queued_ms(torch, fn, 20, filler)
        for name, fn in (("kernel", lambda: pack.pack_faces(u)),
                         ("plain", lambda: pack.pack_faces_plain(u)),
                         ("library", library),
                         ("copy", lambda: copy_dst.copy_(copy_src)))
    }
    if not all(queued for _, queued in timed.values()):
        fail(f"pack timing: the host fell behind the filler: {timed}")
    kernel_ms, plain_ms, library_ms, copy_ms = (
        timed[k][0] for k in ("kernel", "plain", "library", "copy"))
    # the x faces cost a sector per element, the y faces their rows
    nbytes = 2 * nz * ny * SECTOR_BYTES + 2 * nz * nx * item + faces
    out = {
        "kernel": PACK_KERNEL[0], "shape": [nz, ny, nx], "dtype": "float32",
        "kernel_ms": kernel_ms, "call_ms": call_ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library_call": "four u[:, 0, :].contiguous()-style slice copies",
        "copy_ms": copy_ms, "bytes": nbytes, "ops": 0,
        "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    emit({"times": {**out, "elapsed_s": time.perf_counter() - T0}})
    return out


def measure_dist_steps(torch, mods) -> list:
    """Phase 5, the whole distributed step at 512^3 float32 on a mesh of
    one (exchange through NCCL, update, face recompute, freeze) beside
    its update kernel alone and its exchange alone, per arm and bc."""
    from tpu_comm_torch.comm import halo, launch
    from tpu_comm_torch.kernels.distributed import make_local_step
    from tpu_comm_torch.topo import make_cart_mesh

    shape = (SIZES[3],) * 3
    u = random_field(torch, shape, torch.float32, seed=42)
    dst = torch.empty_like(u)
    rows = []
    with launch.process_group("nccl"):
        for impl, pack in (("block", "kernel"), ("block", "fused"),
                           ("stream", "kernel"), ("overlap", "kernel"),
                           ("torch", "fused")):
            for bc in ("dirichlet", "periodic"):
                cart = make_cart_mesh(3, periodic=bc == "periodic")
                step = make_local_step(cart, bc, impl, pack=pack)
                dist_step_ms = time_ms(torch, lambda: step(u, out=dst), 20)
                # the exchange alone: pack, post, wait (the torch arm's
                # chained pad_halo has no such part)
                exchange_ms = None
                if impl != "torch":
                    start = (halo.start_exchange_ghosts_3d_packed
                             if pack == "kernel"
                             else halo.start_exchange_ghosts)
                    exchange_ms = time_ms(
                        torch, lambda: start(u, cart).wait(), 20)
                kernel_ms = None
                if impl in KERNELS:
                    kernel = mods[3].STEPS[impl]
                    kernel_ms = time_ms(
                        torch, lambda: kernel(u, "periodic", out=dst), 20)
                rows.append({"impl": impl, "pack": pack, "bc": bc,
                             "shape": list(shape), "dtype": "float32",
                             "dist_step_ms": dist_step_ms,
                             "kernel_ms": kernel_ms,
                             "exchange_ms": exchange_ms})
                emit({"dist_step": {**rows[-1],
                                    "elapsed_s": time.perf_counter() - T0}})
    del u, dst
    torch.cuda.empty_cache()
    return rows


def membw_kernel_of(op: str, arm: str) -> str:
    """The membw kernel an (op, arm) pass launches."""
    if arm == "stream":
        return "membw_stream"
    if arm == "dma":
        return "membw_dma"
    return "membw_unary" if op in ("copy", "scale") else "membw_binary"


def _hold(torch, name: str, got, want, errs: dict, what: str) -> None:
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    errs[name] = max(errs[name], err)
    if got.dtype != want.dtype or not torch.equal(got, want):
        fail(f"{name} {what}: kernel != plain (max abs err {err})")


def check_membw(torch) -> dict:
    """Phase 3, membw: each kernel against its plain version, bitwise;
    returns the max abs error per kernel (0.0 when every case was
    equal)."""
    from tpu_comm_torch.kernels import membw

    errs = {name: 0.0 for name in MEMBW_KERNELS}
    cases = {name: 0 for name in MEMBW_KERNELS}
    for n in (MEMBW_N, MEMBW_RAGGED):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            x = random_field(torch, (n,), dtype, seed=20)
            b = random_field(torch, (n,), dtype, seed=21)
            for op in ("copy", "scale", "add", "triad"):
                name = membw_kernel_of(op, "chunked")
                want = membw.step_plain(x, b, MEMBW_S, op)
                for aliased in (False, True):
                    for rows in (None, MEMBW_ODD_CHUNK):
                        src = x.clone() if aliased else x
                        got = membw.step_chunked(src, b, MEMBW_S, op, rows,
                                                 aliased)
                        if aliased and got.data_ptr() != src.data_ptr():
                            fail(f"{name} aliased did not write in place")
                        _hold(torch, name, got, want, errs,
                              f"{op} n={n} {dtype} aliased={aliased} "
                              f"chunk={rows}")
                        cases[name] += 1
                        del src, got
                del want
            want = membw.copy_plain(x)
            for aliased in (False, True):
                for rows in (None, MEMBW_ODD_CHUNK):
                    src = x.clone() if aliased else x
                    got = membw.step_stream(src, rows, aliased=aliased)
                    _hold(torch, "membw_stream", got, want, errs,
                          f"n={n} {dtype} aliased={aliased} chunk={rows}")
                    cases["membw_stream"] += 1
                    del src, got
            for depth in (2, 3, 4):
                for rows in (None, MEMBW_ODD_CHUNK):
                    got = membw.step_dma(x, rows, depth)
                    _hold(torch, "membw_dma", got, want, errs,
                          f"n={n} {dtype} depth={depth} chunk={rows}")
                    cases["membw_dma"] += 1
                    del got
            del x, b, want
            torch.cuda.empty_cache()
    # fewer chunks than slots: on the whole card (3 chunks, depth 4) and
    # per CTA (a depth-4 ring of 32 KiB slots fits once on an SM, so
    # 3 chunks per SM give each CTA 3 < 4 chunks)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, rows, depth in ((128 * 3, 1, 4), (sms * 3 * 64 * 128, 64, 4)):
        x = random_field(torch, (n,), torch.float32, seed=22)
        _hold(torch, "membw_dma", membw.step_dma(x, rows, depth), x, errs,
              f"n={n} depth={depth} chunk={rows} (fewer chunks than slots)")
        cases["membw_dma"] += 1
    for name in MEMBW_KERNELS:
        emit({"check": {"kernel": name, "cases": cases[name],
                        "sizes": [MEMBW_N, MEMBW_RAGGED], "s": MEMBW_S,
                        "max_abs_err": errs[name],
                        "tolerance": "bitwise (torch.equal)",
                        "elapsed_s": time.perf_counter() - T0}})
    return errs


def check_stream_loads(libs) -> None:
    """The stream copy must keep the 1D stencil's two neighbour loads:
    count the global loads in each instantiation's machine code."""
    from tpu_comm_torch.kernels import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(tool), "-sass", libs["membw"]._name], capture_output=True,
        text=True, timeout=120, check=True,
    ).stdout
    loads = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split(None, 1)[0]
        if "membw_stream" in fn:
            loads[fn] = sum("LDG" in line for line in part.splitlines())
    emit({"stream_loads": {"global_loads_per_kernel": loads,
                           "elapsed_s": time.perf_counter() - T0}})
    if len(loads) != 3 or min(loads.values()) < 3:
        fail(f"membw_stream lost its neighbour loads: {loads}")


def drive_membw(torch, counters) -> dict:
    """Phase 4, membw: ``membw --op OP --impl ARM`` per pair; returns each
    membw kernel's launches summed over the runs."""
    from tpu_comm_torch import cli

    launches = {name: 0 for name in MEMBW_KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        for op, arm in MEMBW_RUNS:
            path = Path(tmp) / f"membw-{op}-{arm}.jsonl"
            for w in counters.values():
                w.launches = 0
            rc = cli.main(["membw", "--op", op, "--impl", arm,
                           "--jsonl", str(path)])
            counts = {k: w.launches for k, w in counters.items()}
            if rc != 0:
                fail(f"membw --op {op} --impl {arm} exited {rc}")
            rows = [json.loads(line)
                    for line in path.read_text().splitlines()]
            impls = ["chunked", "torch"] if arm == "both" else [arm]
            if [r.get("impl") for r in rows] != impls:
                fail(f"membw --impl {arm} wrote rows {rows}")
            for r in rows:
                if r.get("platform") != "cuda" or r.get("verified") is not True:
                    fail(f"membw {op}/{r.get('impl')}: row says "
                         f"platform={r.get('platform')} "
                         f"verified={r.get('verified')}")
            wrapper = MEMBW_WRAPPER.get(arm)
            if wrapper is not None and counts[wrapper] == 0:
                fail(f"{wrapper} did not launch its kernel in membw --op "
                     f"{op} --impl {arm}")
            if any(c for k, c in counts.items() if k != wrapper):
                fail(f"membw --op {op} --impl {arm} launched other "
                     f"kernels: {counts}")
            if wrapper is not None:
                launches[membw_kernel_of(op, arm)] += counts[wrapper]
            emit({"main_path": {
                "membw": {"op": op, "impl": arm}, "launches": counts,
                "gbps_eff": {r["impl"]: r["gbps_eff"] for r in rows},
                "secs_per_iter": {r["impl"]: r["secs_per_iter"]
                                  for r in rows},
                "elapsed_s": time.perf_counter() - T0}})
    return launches


def measure_membw(torch) -> dict:
    """Phase 5, membw: per-pass times at 2^26 float32 elements, per
    (kernel, op)."""
    from tpu_comm_torch.bench import TRAFFIC
    from tpu_comm_torch.kernels import membw

    n = MEMBW_N
    x = random_field(torch, (n,), torch.float32, seed=30)
    b = random_field(torch, (n,), torch.float32, seed=31)
    dst = torch.empty_like(x)
    s = MEMBW_S
    kernel_call = {
        "membw_unary": lambda op: membw.step_chunked(x, b, s, op, out=dst),
        "membw_binary": lambda op: membw.step_chunked(x, b, s, op, out=dst),
        "membw_stream": lambda op: membw.step_stream(x, out=dst),
        "membw_dma": lambda op: membw.step_dma(x, out=dst),
    }
    library = {
        "copy": ("dst.copy_(x)", lambda: dst.copy_(x)),
        "scale": ("torch.mul(x, s, out=dst)",
                  lambda: torch.mul(x, s, out=dst)),
        "add": ("torch.add(x, b, out=dst)", lambda: torch.add(x, b, out=dst)),
        "triad": ("torch.add(b, x, alpha=s, out=dst)",
                  lambda: torch.add(b, x, alpha=s, out=dst)),
    }
    out = {}
    for name, (_, ops, _) in MEMBW_KERNELS.items():
        for op in ops:
            kernel_ms = time_ms(torch, lambda: kernel_call[name](op), 50)
            got = kernel_call[name](op).clone()
            plain_ms = time_ms(
                torch, lambda: membw.step_plain(x, b, s, op, out=dst), 20)
            call, lib = library[op]
            library_ms = time_ms(torch, lib, 50)
            lib_err = float((lib() - got).abs().max())
            nbytes = TRAFFIC[op] * n * x.element_size()
            ops_n = MEMBW_OPS_PER_ELEM[op] * n
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = ops_n / PEAK_F32_OPS_PER_S * 1e3
            out[(name, op)] = {
                "kernel": name, "op": op, "shape": [n], "dtype": "float32",
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "library_call": call,
                "library_max_abs_err": lib_err,
                "bytes": nbytes, "ops": ops_n,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "gbps": nbytes / kernel_ms / 1e6,
            }
            emit({"times": {**out[(name, op)],
                            "elapsed_s": time.perf_counter() - T0}})
            del got
    del x, b, dst
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
    from tpu_comm_torch.kernels import _build, membw, pack, stencil_module

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
    counters = {
        KERNELS[arm][dim][0]: mods[dim].STEPS[arm]
        for arm in KERNELS for dim in mods
    }
    counters[PACK_KERNEL[0]] = pack.pack_faces
    counters.update({f"membw.{w.__name__}": w for w in membw.WRAPPERS})
    errs = {arm: check_kernels(torch, mods, arm) for arm in KERNELS}
    pack_err = check_pack(torch)
    membw_errs = check_membw(torch)
    check_stream_loads(libs)
    launches = drive_main_path(torch, mods, counters)
    membw_launches = drive_membw(torch, counters)
    mesh_launches = drive_mesh(torch, counters)
    times = {arm: measure_times(torch, mods, arm) for arm in KERNELS}
    pack_times = measure_pack(torch)
    membw_times = measure_membw(torch)
    measure_dist_steps(torch, mods)

    print(smi, flush=True)
    stencil_rows = []
    for arm in KERNELS:
        for dim in (1, 2, 3):
            name, replaces = KERNELS[arm][dim]
            t = times[arm][dim]
            stencil_rows.append({
                "name": name, "route": "cuda", "source": SOURCES[arm],
                "replaces": replaces,
                # the stream kernels: the single-device run plus the mesh
                # runs that use them; the block kernels: their mesh runs
                "launches": mesh_launches[name]
                + (launches[dim] if arm == "stream" else 0),
                "max_abs_err": errs[arm][dim], "ms": t["kernel_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "copy_ms": t["copy_ms"],
                "chunked_copy_ms": t["chunked_copy_ms"],
                "shape": t["shape"], "dtype": "float32",
            })
    pack_row = {
        "name": PACK_KERNEL[0], "route": "cuda", "source": PACK_SOURCE,
        "replaces": PACK_KERNEL[1],
        "launches": mesh_launches[PACK_KERNEL[0]], "max_abs_err": pack_err,
        "ms": pack_times["kernel_ms"], "plain_ms": pack_times["plain_ms"],
        "bound_ms": pack_times["bound_ms"],
        "bound_by": pack_times["bound_by"],
        "library_ms": pack_times["library_ms"],
        "copy_ms": pack_times["copy_ms"], "call_ms": pack_times["call_ms"],
        "shape": pack_times["shape"], "dtype": "float32",
    }
    membw_rows = []
    for name, (replaces, _, op) in MEMBW_KERNELS.items():
        t = membw_times[(name, op)]
        membw_rows.append({
            "name": name, "route": "cuda", "source": MEMBW_SOURCE,
            "replaces": replaces, "launches": membw_launches[name],
            "max_abs_err": membw_errs[name], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "op": op, "shape": t["shape"], "dtype": "float32",
        })
    emit({"kernels": stencil_rows + [pack_row] + membw_rows})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
