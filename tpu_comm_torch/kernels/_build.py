"""Build the port's CUDA sources at first use and bind them with ctypes.

Every ``csrc/*.cu`` listed in :data:`SOURCES` is compiled by ``nvcc`` into
a shared library with a plain C interface under ``build/torch_ext/`` at
the root of the checkout (ignored by git). One ``nvcc`` per source, all
started together. A library is named by a hash of its source, the flags
and the compiler, so an edited source rebuilds and an unchanged one is
loaded as it is. Nothing here runs at import time: the first kernel
launch calls :func:`libraries`.

No PyTorch header is compiled (a source that includes ``torch/extension.h``
takes minutes to build); the wrappers pass ``tensor.data_ptr()`` and the
current stream's handle as integers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
SOURCES = ("jacobi_stream.cu", "membw.cu", "jacobi_block.cu", "pack.cu")
NVCC_FLAGS = (
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    # the kernels' f32 association must stay bitwise: no FMA contraction
    "-fmad=false",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)
_P = ctypes.c_void_p
_I = ctypes.c_int
_N = ctypes.c_int64
#: C signature of every exported launcher: argument types; each returns
#: a cudaError_t as int. Every source also exports ``tc_error_string``.
SIGNATURES = {
    "tc_jacobi1d_stream": (_P, _P, _N, _I, _I, _I, _P),
    "tc_jacobi2d_stream": (_P, _P, _I, _I, _I, _I, _I, _P),
    "tc_jacobi3d_stream": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "tc_jacobi1d_block": (_P, _P, _N, _I, _I, _P),
    "tc_jacobi2d_block": (_P, _P, _I, _I, _I, _I, _P),
    "tc_jacobi3d_block": (_P, _P, _I, _I, _I, _I, _I, _P),
    "tc_pack_faces": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "tc_membw_chunked": (_P, _P, _P, _N, _I, _I, ctypes.c_float, _I, _P),
    "tc_membw_stream": (_P, _P, _N, _I, _I, _P),
    "tc_membw_dma": (_P, _P, _N, _I, _I, _I, _P),
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from tpu_comm_torch/csrc at first use"
    )


def _target(src: Path, nvcc: str) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update("\0".join((nvcc, *NVCC_FLAGS)).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


@functools.cache
def libraries() -> dict[str, ctypes.CDLL]:
    """Build (where needed) and load every source; ``{stem: library}``.

    Concurrent builds are safe: each process compiles to a private file and
    renames it into place.
    """
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SOURCES:
        src = CSRC / name
        target = _target(src, nvcc)
        if target.exists():
            jobs.append((src, target, None, None))
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((src, target, tmp, proc))
    failures = []
    for src, target, tmp, proc in jobs:
        if proc is None:
            continue
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    libs = {}
    for src, target, _, _ in jobs:
        lib = ctypes.CDLL(str(target))
        for sym, argtypes in SIGNATURES.items():
            if hasattr(lib, sym):
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.tc_error_string.argtypes = (ctypes.c_int,)
        lib.tc_error_string.restype = ctypes.c_char_p
        libs[src.stem] = lib
    return libs


def launch(symbol: str, *args) -> None:
    """Call the C launcher ``symbol`` from the library that exports it;
    raise RuntimeError with CUDA's message if the launch was refused."""
    for lib in libraries().values():
        if hasattr(lib, symbol):
            code = getattr(lib, symbol)(*args)
            if code != 0:
                msg = lib.tc_error_string(code).decode()
                raise RuntimeError(
                    f"{symbol} launch failed: CUDA error {code} ({msg})"
                )
            return
    raise RuntimeError(f"no built library exports {symbol}")
