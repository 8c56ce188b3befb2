"""The sm_90a build check of every CUDA kernel, with no GPU (the port's
counterpart of ``tpu_comm/bench/aot.py``).

JAX's module compiles every Pallas kernel for a TPU topology with no chip
and returns ``{name: "ok" | "error: <msg>"}``. Here every ``csrc/``
source is built for sm_90a with ``kernels/_build.py``'s flags, through its
target cache (a library built before is reused, never rebuilt), and each
of JAX's 86 named cases (:func:`kernel_cases`) is held to two things:

(a) the pre-launch checks of the wrapper it stands for accept its shape,
    dtype and knobs (:func:`check_case`: the tensor-free halves of those
    checks, ``tiling.check_field``, the families' ``check_chunk``,
    ``tiling.multi_launch_plan``, ``membw.check_dma_ring``, ...);
(b) the kernel instantiations its launch takes are among the functions of
    the machine code of the library that exports its launcher
    (``cuobjdump -sass``, :func:`sass_functions`).

Nothing is loaded onto a device and no CUDA runtime call is made, so it
runs on a machine with ``nvcc`` and no GPU. Without ``nvcc`` every case
reads ``error: nvcc not found ...``. A case never raises.

A case whose only difference is a knob that exists on the TPU alone
(Mosaic's ``dimsem`` grid semantics; CUDA blocks are unordered) maps to
the kernel without it, and its ``tpu_knob`` names the knob. Chunks are in
the port's units, which are JAX's: rows of 128 cells in 1D and membw,
rows of a strip or tile in 2D, planes in 3D. :data:`REFUSED` lists the
cases the port refuses although JAX accepts them, each with its entry in
ROADMAP.md queue C.

:func:`resource_usage` reads each kernel's registers, static shared
memory and local (spill) bytes from ``cuobjdump --dump-resource-usage``.
"""

from __future__ import annotations

import concurrent.futures
import functools
import importlib
import math
import re
import subprocess
from dataclasses import dataclass
from pathlib import Path

from tpu_comm_torch.kernels import _build, tiling
from tpu_comm_torch.kernels.reference import check_bc

#: the cases the port refuses at a knob JAX accepts, with the reason
#: (ROADMAP.md queue C); the build check reads ``error`` for them
REFUSED = {
    "membw.dma.d4.c2048": (
        "C8: the dma ring lives in shared memory; 4 slots of 2048 rows "
        "need 4 MiB, a block has 227 KiB"),
    "jacobi2d.pallas_wave.c64.large": (
        "C8: the 2D wave kernel's 4-slot ring of 64 rows of a 256-column "
        "strip needs 276576 bytes of shared memory in float32"),
}

#: the element type of each ``--dtype`` in the kernels' templates
CTYPES = {"float32": "float", "bfloat16": "__nv_bfloat16",
          "float16": "__half"}
#: the unsigned word the copies and the pack move a cell as, by itemsize
WORDS = {4: "uint32_t", 2: "uint16_t"}
#: Itanium mangling of the template arguments above
_MANGLED = {"float": "f", "__nv_bfloat16": "13__nv_bfloat16",
            "__half": "6__half", "uint32_t": "j", "uint16_t": "t"}
#: field rank of each stencil family
DIMS = {"jacobi1d": 1, "jacobi2d": 2, "jacobi3d": 3, "stencil9": 2,
        "stencil27": 3}
#: the wrapper each arm stands for, in its family's module
WRAPPERS = {"stream": "step_stream", "stream2": "step_stream2",
            "grid": "step_grid", "wave": "step_wave",
            "block": "step_block", "multi": "step_multi",
            "wave_ghost": "step_wave_ghost", "chunked": "step_chunked",
            "dma": "step_dma", "pack": "pack_faces"}
#: the kernel a stencil arm's launch takes ({T}: element type, {p}:
#: periodic, {rows}: the 27-point wave's tile rows)
_STENCIL_FORMS = {
    ("jacobi1d", "stream"): "jacobi1d_kernel<{T}, {p}, false>",
    ("jacobi1d", "stream2"): "jacobi1d_kernel<{T}, {p}, true>",
    ("jacobi2d", "stream"): "jacobi2d_kernel<{T}, {p}>",
    ("jacobi3d", "stream"): "jacobi3d_kernel<{T}, {p}>",
    ("stencil9", "stream"): "stencil9_stream_kernel<{T}, {p}>",
    ("stencil27", "stream"): "stencil27_stream_kernel<{T}, {p}>",
    ("jacobi1d", "grid"): "jacobi1d_grid_kernel<{T}, {p}>",
    ("jacobi2d", "grid"): "jacobi2d_grid_kernel<{T}, {p}>",
    ("jacobi1d", "wave"): "jacobi1d_wave_kernel<{T}, false>",
    ("jacobi2d", "wave"): "wave2d_kernel<{T}, false, false>",
    ("stencil9", "wave"): "wave2d_kernel<{T}, true, false>",
    ("stencil27", "wave"): "stencil27_wave_kernel<{T}, {rows}>",
    ("jacobi1d", "wave_ghost"): "jacobi1d_wave_kernel<{T}, true>",
    ("jacobi2d", "wave_ghost"): "wave2d_kernel<{T}, false, true>",
    ("jacobi1d", "multi"): "jacobi1d_multi_kernel<{Tin}, {Tout}, {p}>",
    ("jacobi2d", "multi"): "multi2d_kernel<{Tin}, {Tout}, {p}, false>",
    ("stencil9", "multi"): "multi2d_kernel<{Tin}, {Tout}, {p}, true>",
    ("jacobi3d", "multi"): "jacobi3d_multi_kernel<{Tin}, {Tout}, {t}>",
}
#: the function of a family's module that gives an arm's default chunk
_DEFAULT_CHUNK = {"stream": "default_chunk", "stream2": "default_chunk",
                  "grid": "default_grid_chunk", "wave": "default_wave_chunk"}
#: the 27-point wave kernel's tile-row instantiations
#: (``csrc/wave.cu`` launch27_rows)
_WAVE27_ROWS = (8, tiling.WAVE3D_MAX_ROWS)


@dataclass(frozen=True)
class Case:
    """One of JAX's named build cases in the port's terms: the wrapper of
    ``family``'s ``arm`` at ``shape`` and ``dtype`` with its knobs (None:
    the wrapper's default). ``op`` is the membw op; ``tpu_knob`` names
    the TPU-only knob the JAX case sets, which the port has not."""

    name: str
    family: str
    arm: str
    shape: tuple[int, ...]
    dtype: str = "float32"
    bc: str = "dirichlet"
    chunk: int | None = None
    t_steps: int | None = None
    depth: int | None = None
    aliased: bool = False
    op: str | None = None
    tpu_knob: str | None = None

    @property
    def module(self):
        return importlib.import_module(f"tpu_comm_torch.kernels.{self.family}")

    @property
    def wrapper(self) -> str:
        """``module.function`` of the wrapper the case stands for."""
        return f"{self.family}.{WRAPPERS[self.arm]}"

    @property
    def symbol(self) -> str:
        """The C launcher the wrapper calls (``_build.SIGNATURES``)."""
        if self.family == "membw":
            return f"tc_membw_{self.arm}"
        if self.family == "pack":
            return "tc_pack_faces"
        return f"tc_{self.family}_{self.arm}"

    @property
    def source(self) -> str:
        """The ``csrc/`` file that defines :attr:`symbol`."""
        return source_of(self.symbol)

    def run(self, x):
        """Launch the case through its wrapper on ``x``, a CUDA tensor of
        its shape and dtype; returns the wrapper's result."""
        import torch

        mod = self.module
        wrapper = getattr(mod, WRAPPERS[self.arm])
        if self.family == "membw":
            if self.arm == "chunked":
                b = (torch.ones_like(x) if self.op in mod.BINARY_OPS
                     else None)
                return wrapper(x, b, 2.0, self.op, self.chunk, self.aliased)
            if self.arm == "stream":
                return wrapper(x, self.chunk, aliased=self.aliased)
            return wrapper(x, self.chunk,
                           self.depth or tiling.DEFAULT_DMA_DEPTH)
        if self.family == "pack":
            return wrapper(x)
        if self.arm == "multi":
            return wrapper(x, self.bc, self.t_steps)
        if self.arm == "wave_ghost":
            ghosts = ((x[:1], x[:1]) if x.dim() == 1 else
                      (x[:1, :], x[:1, :], x[:, :1], x[:, :1]))
            return wrapper(x, *ghosts, self.chunk)
        if self.arm == "block":
            return wrapper(x, self.bc)
        return wrapper(x, self.bc, self.chunk)


@functools.cache
def source_of(symbol: str) -> str:
    """The one ``csrc/*.cu`` file that defines the C launcher
    ``symbol``."""
    hits = [p.name for p in sorted(_build.CSRC.glob("*.cu"))
            if re.search(rf"^int {symbol}\(", p.read_text(), re.M)]
    if len(hits) != 1:
        raise ValueError(f"{symbol} is defined in {hits or 'no source'}")
    return hits[0]


def kernel_cases() -> list[Case]:
    """JAX's 86 build cases (``tpu_comm/bench/aot.py`` ``kernel_cases``),
    by name, in its order, each as the wrapper it stands for."""
    f16, bf16 = "float16", "bfloat16"
    par, arb = "dimsem=parallel", "dimsem=arbitrary"
    m20, m23, m26 = (1 << 20,), (1 << 23,), (1 << 26,)
    s2, s3 = (2048, 512), (64, 64, 128)
    big2, full3, flag3 = (8192, 8192), (384, 384, 384), (16, 384, 384)
    C = Case
    return [
        C("membw.copy", "membw", "chunked", m20, op="copy"),
        C("membw.triad", "membw", "chunked", m20, op="triad"),
        C("membw.triad.bf16", "membw", "chunked", m20, bf16, op="triad"),
        C("membw.scale", "membw", "chunked", m20, op="scale"),
        C("membw.add", "membw", "chunked", m20, op="add"),
        C("membw.copy.aliased", "membw", "chunked", m20, op="copy",
          aliased=True),
        C("membw.copy.parallel", "membw", "chunked", m20, op="copy",
          tpu_knob=par),
        C("membw.copy.arbitrary", "membw", "chunked", m20, op="copy",
          tpu_knob=arb),
        C("membw.copy.aliased.parallel", "membw", "chunked", m20,
          op="copy", aliased=True, tpu_knob=par),
        C("membw.triad.aliased", "membw", "chunked", m20, op="triad",
          aliased=True),
        C("membw.copy.c4096", "membw", "chunked", m23, op="copy",
          chunk=4096),
        C("membw.copy.c8192", "membw", "chunked", m23, op="copy",
          chunk=8192),
        C("membw.stream", "membw", "stream", m20),
        C("membw.stream.aliased.parallel", "membw", "stream", m20,
          aliased=True, tpu_knob=par),
        C("membw.dma", "membw", "dma", m20),
        C("membw.dma.d3", "membw", "dma", m20, depth=3),
        C("membw.dma.d4.c2048", "membw", "dma", m23, chunk=2048, depth=4),
        C("membw.stream.c2048", "membw", "stream", m23, chunk=2048),
        C("jacobi1d.pallas_stream.parallel", "jacobi1d", "stream", m20,
          tpu_knob=par),
        C("jacobi2d.pallas_stream.parallel", "jacobi2d", "stream", s2,
          tpu_knob=par),
        C("jacobi3d.pallas_stream.parallel", "jacobi3d", "stream", s3,
          tpu_knob=par),
        C("stencil9.pallas_stream.parallel", "stencil9", "stream", s2,
          tpu_knob=par),
        C("stencil27.pallas_stream.parallel", "stencil27", "stream", s3,
          tpu_knob=par),
        C("pack.pack_faces_3d.parallel", "pack", "pack", s3,
          tpu_knob=par),
        C("jacobi1d.pallas_stream.f16", "jacobi1d", "stream", m20, f16),
        C("jacobi1d.pallas_stream2.f16", "jacobi1d", "stream2", m20, f16),
        C("jacobi1d.pallas_stream.f16.full", "jacobi1d", "stream", m26,
          f16),
        C("jacobi2d.pallas_stream.f16", "jacobi2d", "stream", s2, f16),
        C("jacobi3d.pallas_stream.f16", "jacobi3d", "stream", s3, f16),
        C("stencil9.pallas_stream.f16", "stencil9", "stream", s2, f16),
        C("stencil27.pallas_stream.f16", "stencil27", "stream", s3, f16),
        C("jacobi1d.pallas", "jacobi1d", "block", (1 << 16,)),
        C("jacobi1d.pallas_grid", "jacobi1d", "grid", m20),
        C("jacobi1d.pallas_stream", "jacobi1d", "stream", m20),
        C("jacobi1d.pallas_stream2", "jacobi1d", "stream2", m20),
        C("jacobi1d.pallas_wave.full", "jacobi1d", "wave", m26),
        C("jacobi2d.pallas", "jacobi2d", "block", (512, 512)),
        C("jacobi2d.pallas_grid", "jacobi2d", "grid", s2),
        C("jacobi2d.pallas_stream", "jacobi2d", "stream", s2),
        C("stencil9.pallas", "stencil9", "block", (512, 512)),
        C("stencil9.pallas_stream", "stencil9", "stream", s2),
        C("stencil9.pallas_stream.large", "stencil9", "stream", big2),
        C("stencil9.pallas_stream.bf16", "stencil9", "stream", s2, bf16),
        C("stencil9.pallas_wave.large", "stencil9", "wave", big2),
        C("stencil9.pallas_multi.t8.large", "stencil9", "multi", big2,
          t_steps=8),
        C("stencil9.pallas_multi.t8.periodic", "stencil9", "multi", s2,
          bc="periodic", t_steps=8),
        C("stencil9.pallas_multi.t8.bf16", "stencil9", "multi", s2, bf16,
          t_steps=8),
        C("stencil27.pallas", "stencil27", "block", s3),
        C("stencil27.pallas.full", "stencil27", "block", flag3),
        C("stencil27.pallas_stream", "stencil27", "stream", s3),
        C("stencil27.pallas_stream.full", "stencil27", "stream", full3),
        C("stencil27.pallas_stream.bf16", "stencil27", "stream", s3, bf16),
        C("stencil27.pallas_wave", "stencil27", "wave", s3),
        C("stencil27.pallas_wave.full", "stencil27", "wave", full3),
        C("stencil27.pallas_wave.bf16.full", "stencil27", "wave", full3,
          bf16),
        C("jacobi3d.pallas", "jacobi3d", "block", s3),
        C("jacobi3d.pallas_stream", "jacobi3d", "stream", s3),
        C("pack.pack_faces_3d", "pack", "pack", s3),
        C("jacobi1d.pallas_stream.bf16", "jacobi1d", "stream", m20, bf16),
        C("jacobi2d.pallas_stream.large", "jacobi2d", "stream", big2),
        C("jacobi2d.pallas_wave.large", "jacobi2d", "wave", big2),
        C("jacobi2d.pallas_wave.c64.large", "jacobi2d", "wave", big2,
          chunk=64),
        C("jacobi2d.pallas_wave.bf16", "jacobi2d", "wave", s2, bf16),
        C("jacobi2d.pallas_wave_ghost.large", "jacobi2d", "wave_ghost",
          (4096, 8192)),
        C("jacobi1d.pallas_wave_ghost.large", "jacobi1d", "wave_ghost",
          m23),
        C("jacobi2d.pallas_stream.bf16", "jacobi2d", "stream", s2, bf16),
        C("jacobi3d.pallas_stream.bf16", "jacobi3d", "stream", s3, bf16),
        C("jacobi3d.pallas_stream.c4.full", "jacobi3d", "stream", full3,
          chunk=4),
        C("pack.pack_faces_3d.large", "pack", "pack", (256, 512, 512)),
        C("jacobi1d.pallas_multi.t8", "jacobi1d", "multi", m20, t_steps=8),
        C("jacobi1d.pallas_multi.t32", "jacobi1d", "multi", m20,
          t_steps=32),
        C("jacobi1d.pallas_multi.t16", "jacobi1d", "multi", m20,
          t_steps=16),
        C("jacobi1d.pallas_stream.c2048", "jacobi1d", "stream", (1 << 22,),
          chunk=2048),
        C("jacobi1d.pallas_stream2.c1024", "jacobi1d", "stream2",
          (1 << 22,), chunk=1024),
        C("jacobi1d.pallas_stream2.c4096", "jacobi1d", "stream2", m23,
          chunk=4096),
        C("jacobi2d.pallas_multi.t8", "jacobi2d", "multi", s2, t_steps=8),
        C("jacobi2d.pallas_multi.t8.periodic", "jacobi2d", "multi", s2,
          bc="periodic", t_steps=8),
        C("jacobi2d.pallas_multi.t8.large", "jacobi2d", "multi", big2,
          t_steps=8),
        C("jacobi2d.pallas.1024", "jacobi2d", "block", (1024, 1024)),
        C("jacobi1d.pallas_multi.t16.bf16", "jacobi1d", "multi", m20, bf16,
          t_steps=16),
        C("jacobi2d.pallas_multi.t8.bf16", "jacobi2d", "multi", s2, bf16,
          t_steps=8),
        C("jacobi3d.pallas_multi.t4", "jacobi3d", "multi", flag3,
          t_steps=4),
        C("jacobi3d.pallas_multi.t8", "jacobi3d", "multi", flag3,
          t_steps=8),
        C("jacobi3d.pallas_multi.t4.bf16", "jacobi3d", "multi", flag3, bf16,
          t_steps=4),
        C("jacobi3d.pallas_multi.t2", "jacobi3d", "multi", flag3,
          t_steps=2),
        C("jacobi3d.pallas_multi.t1.full", "jacobi3d", "multi", full3,
          t_steps=1),
    ]


def _min_extents(case: Case) -> tuple[int, ...] | None:
    """The least extents the case's wrapper takes (3 a side unless
    said)."""
    if case.family == "stencil27" or (
            case.family == "jacobi3d" and case.arm in ("block", "multi")):
        return (2, 3, 3)
    return None


def _check_membw(case: Case) -> tuple[str, ...]:
    from tpu_comm_torch.kernels import membw

    dtype = tiling.torch_dtype(case.dtype)
    tiling.check_membw_size(math.prod(case.shape), dtype)
    if case.arm == "chunked":
        membw.check_op(case.op)
    if case.arm == "dma":
        membw.check_depth(case.depth or tiling.DEFAULT_DMA_DEPTH)
    rows = case.chunk
    if rows is None:
        rows = membw.default_chunk(case.arm, dtype, case.op or "copy")
    else:
        membw.check_chunk(case.arm, dtype.itemsize, rows)
    if case.arm == "dma":
        # the wrapper checks the ring against its card's shared memory a
        # block (the H100's here)
        membw.check_dma_ring(dtype.itemsize, rows,
                             case.depth or tiling.DEFAULT_DMA_DEPTH)
        return ("membw_dma",)
    if case.arm == "stream":
        inplace = "_inplace" if case.aliased else ""
        return (f"membw_stream{inplace}<{WORDS[dtype.itemsize]}>",)
    kind = "binary" if case.op in membw.BINARY_OPS else "unary"
    return (f"membw_{kind}<{CTYPES[case.dtype]}, "
            f"{membw.OP_CODES[case.op]}>",)


def check_case(case: Case) -> tuple[str, ...]:
    """Run the pre-launch checks of ``case``'s wrapper on its shape, dtype
    and knobs, with no tensor, and return the kernel instantiations its
    launch takes (a multi pass beyond ``tiling.MULTI_T_MAX`` chains
    several). Raises ValueError where the wrapper would refuse."""
    if case.family == "membw":
        return _check_membw(case)
    dtype = tiling.torch_dtype(case.dtype)
    T = CTYPES[case.dtype]
    if case.family == "pack":
        tiling.check_field(case.shape, dtype, 3, (1, 1, 1))
        return (f"pack_faces_kernel<{WORDS[dtype.itemsize]}>",)
    mod, dim, shape = case.module, DIMS[case.family], case.shape
    p = "true" if case.bc == "periodic" else "false"
    form = _STENCIL_FORMS.get((case.family, case.arm))
    if case.arm == "wave_ghost":
        tiling.check_field(shape, dtype, dim, (1,) * dim)
        rows = (mod.default_wave_chunk(shape) if case.chunk is None
                else case.chunk)
        if rows < 1:
            raise ValueError(f"chunk must be >= 1, got {rows}")
        tiling.check_staged_smem(
            "wave", tiling.wave_smem(dim, rows, dtype.itemsize), rows)
        return (form.format(T=T),)
    check_bc(case.bc)
    if case.arm == "multi":
        if dim == 3:
            tiling.check_multi3d_bc(case.bc)
        tiling.check_field(shape, dtype, dim, _min_extents(case))
        t = case.t_steps
        if dim == 1:
            tile = (mod.default_multi_chunk(shape) * 128,)
        elif dim == 2:
            from tpu_comm_torch.kernels.jacobi2d import MULTI_DEFAULT_TILE
            tile = MULTI_DEFAULT_TILE
        else:
            tile = tiling.multi3d_default_tile(
                min(t, tiling.MULTI_T_MAX[3]))
        steps, _ = tiling.multi_launch_plan(shape, t, tile)
        last = len(steps) - 1
        return tuple(dict.fromkeys(
            form.format(Tin=T if i == 0 else "float",
                        Tout=T if i == last else "float", p=p, t=k)
            for i, k in enumerate(steps)))
    if case.arm == "wave":
        tiling.check_wave_bc(case.bc)
    tiling.check_field(shape, dtype, dim, _min_extents(case))
    if case.arm == "block":
        return (f"{case.family}_block_kernel<{T}, {p}>",)
    chunk = case.chunk
    if chunk is None:
        chunk = getattr(mod, _DEFAULT_CHUNK[case.arm])(shape)
    mod.check_chunk(case.arm, shape, dtype.itemsize, chunk)
    # the 27-point wave launches the least tile-row form that holds chunk
    rows = next((r for r in _WAVE27_ROWS if chunk <= r), None)
    return (form.format(T=T, p=p, rows=rows),)


def sass_pattern(form: str) -> str:
    """A regex that finds the mangled name of the instantiation ``form``
    (``name<arg, ...>``, the leading template arguments: element types,
    ``true``/``false``, integers; without ``<>`` a function that is no
    template). The name is found by its length prefix, whatever
    precedes it (nvcc names each unnamed namespace
    ``_GLOBAL__N__<hash>_<file>_<hash>``); a type after the first may be
    a substitution (``S1_``)."""
    name, _, rest = form.partition("<")
    head = f"{len(name)}{name}"
    if not rest:
        return head + "(?!I)"
    parts = []
    for i, arg in enumerate(a.strip() for a in rest.rstrip(">").split(",")):
        if arg in _MANGLED:
            code = re.escape(_MANGLED[arg])
            parts.append(code if i == 0 else rf"(?:{code}|S\w*?_)")
        elif arg in ("false", "true"):
            parts.append(f"Lb{int(arg == 'true')}E")
        else:
            parts.append(f"Li{int(arg)}E")
    return head + "I" + "".join(parts)


def _cuobjdump() -> str:
    return str(Path(_build.nvcc_path()).parent / "cuobjdump")


@functools.cache
def _sass(path: str) -> str:
    return subprocess.run(
        [_cuobjdump(), "-sass", path], capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout


def sass_functions(path) -> list[tuple[str, str]]:
    """``(mangled name, machine code)`` of every kernel of the library at
    ``path``, from ``cuobjdump -sass`` (read once a path: a library's
    name holds the hash of what built it)."""
    sass = _sass(str(path))
    return [(part.split(None, 1)[0], part)
            for part in sass.split("Function : ")[1:]]


def resource_usage(path) -> dict[str, dict[str, int]]:
    """``{mangled name: {"registers", "shared", "local", "stack"}}`` of
    every kernel of the library at ``path``, from ``cuobjdump
    --dump-resource-usage``: registers a thread, static shared memory,
    local memory (spills) and stack bytes a thread."""
    text = subprocess.run(
        [_cuobjdump(), "--dump-resource-usage", str(path)],
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    table, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function (\S+?):\s*$", line)
        if m:
            fn = m.group(1)
        elif fn is not None and "REG:" in line:
            vals = dict(re.findall(r"([A-Z]+):(\d+)", line))
            table[fn] = {"registers": int(vals["REG"]),
                         "shared": int(vals["SHARED"]),
                         "local": int(vals["LOCAL"]),
                         "stack": int(vals["STACK"])}
            fn = None
    return table


def kernel_name(mangled: str) -> str:
    """The function name of a mangled kernel name, past any unnamed
    namespace (``_ZN<n>_GLOBAL__N_...15jacobi1d_kernelI...`` ->
    ``jacobi1d_kernel``)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    while (m := re.match(r"\d+", mangled[pos:])) is not None:
        start = pos + m.end()
        ident = mangled[start:start + int(m.group())]
        if not ident.startswith("_GLOBAL__N"):
            return ident
        pos = start + len(ident)
    return mangled


def compile_all_kernels() -> dict[str, str]:
    """Build every source for sm_90a and hold every case of
    :func:`kernel_cases` to its wrapper's checks and its library's
    machine code; ``{name: "ok" | "error: <msg>"}``. Never raises."""
    cases = kernel_cases()
    try:
        built = _build.build_sources()
    except RuntimeError as e:  # no nvcc
        return {c.name: f"error: {str(e)[:200]}" for c in cases}
    def names(lib):
        try:
            return [name for name, _ in sass_functions(lib)]
        except (OSError, subprocess.SubprocessError) as e:
            return RuntimeError(f"cuobjdump failed: {e}")

    libs = {k: v for k, v in built.items() if not isinstance(v, Exception)}
    with concurrent.futures.ThreadPoolExecutor(max(len(libs), 1)) as pool:
        functions = dict(zip(libs, pool.map(names, libs.values())))
    out = {}
    for case in cases:
        try:
            forms = check_case(case)
            stem = Path(case.source).stem
            for got in (built[stem], functions.get(stem)):
                if isinstance(got, Exception):
                    raise got
            names = functions[stem]
            missing = [f for f in forms if not any(
                re.search(sass_pattern(f), n) for n in names)]
            if missing:
                raise ValueError(
                    f"{case.source} holds no {', '.join(missing)}")
            out[case.name] = "ok"
        except Exception as e:  # a case never raises
            out[case.name] = f"error: {str(e)[:200]}"
    return out
