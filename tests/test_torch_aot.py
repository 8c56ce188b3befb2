"""The port's sm_90a build check (``tpu_comm_torch/bench/aot.py``) on the
CPU, held against the JAX package's ``tpu_comm/bench/aot.py``.

- ``kernel_cases()`` names JAX's 86 cases, in JAX's order; each maps to
  a wrapper of the port, its C launcher (``_build.SIGNATURES``) and the
  one ``csrc/`` source that defines it.
- Each case's pre-launch checks pass here (no tensor, no card), but
  those of ``aot.REFUSED``, which the wrappers' checks refuse (ROADMAP.md
  C8).
- With no ``nvcc`` every entry reads ``error: nvcc not found`` and
  nothing raises.
- With a stand-in ``nvcc`` and ``cuobjdump`` (a monkeypatched
  ``subprocess.run``): one ``nvcc`` a source carrying ``_build``'s flags
  (sm_90a, ``-fmad=false``), a second run rebuilds nothing, one failing
  source gives ``error:`` for its own cases only, and an instantiation
  missing from the machine code fails its case.

The card runs the real build (``tests/test_torch_cuda.py``).
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from tpu_comm.bench import aot as jaot
from tpu_comm_torch.bench import aot
from tpu_comm_torch.kernels import _build

CASES = aot.kernel_cases()
NAMES = [c.name for c in CASES]


def test_case_names_are_jaxs_86_in_order():
    assert NAMES == [name for name, _, _ in jaot.kernel_cases()]
    assert len(NAMES) == len(set(NAMES)) == 86
    assert set(aot.REFUSED) <= set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_case_maps_to_a_wrapper_launcher_and_source(name):
    case = CASES[NAMES.index(name)]
    jshape, jdtype = dict((n, sd) for n, _, sd in jaot.kernel_cases())[name]
    assert (case.shape, case.dtype) == (tuple(jshape),
                                        np.dtype(jdtype).name)
    wrapper = getattr(case.module, case.wrapper.split(".")[1])
    assert hasattr(wrapper, "launches")
    assert case.symbol in _build.SIGNATURES
    assert case.source in _build.SOURCES
    # the case's TPU-only knob is in its JAX name, and only there
    assert (case.tpu_knob is not None) == (
        ".parallel" in name or ".arbitrary" in name)
    if name in aot.REFUSED:
        with pytest.raises(ValueError) as e:
            aot.check_case(case)
        assert str(e.value)
    else:
        forms = aot.check_case(case)
        assert forms and all(f.split("<")[0] in
                             (_build.CSRC / case.source).read_text()
                             for f in forms)


@pytest.mark.parametrize("name", sorted(aot.REFUSED))
def test_refused_cases_are_refused_by_their_wrappers_checks(name):
    """ROADMAP.md C8: the port refuses these knobs where JAX accepts
    them; the wrappers' own checks say why."""
    from tpu_comm_torch.kernels import jacobi2d, membw

    with pytest.raises(ValueError, match="shared memory"):
        if name == "membw.dma.d4.c2048":
            membw.check_dma_ring(4, 2048, 4)
        else:
            jacobi2d.check_chunk("wave", (8192, 8192), 4, 64)
    with pytest.raises(ValueError, match="shared memory"):
        aot.check_case(CASES[NAMES.index(name)])


def test_without_nvcc_every_case_says_so_and_nothing_raises(monkeypatch,
                                                            tmp_path):
    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed at its default place")
    result = aot.compile_all_kernels()
    assert list(result) == NAMES
    assert all(v.startswith("error: nvcc not found") for v in result.values())


# ------------------------------------------------- a stand-in toolchain

_CODES = {"float": "f", "__nv_bfloat16": "13__nv_bfloat16",
          "__half": "6__half", "uint32_t": "j", "uint16_t": "t"}
#: the template arguments the forms leave out (each kernel's vector
#: width), as the card's mangled names carry them
_TRAILING = {"_block_kernel": "Li4E", "membw_unary": "Lb1E",
             "membw_binary": "Lb1E", "membw_stream": "Lb0E",
             "pack_faces_kernel": "Lb1E"}


#: the name nvcc gives a source's unnamed namespace (as it named box.cu's
#: on the card)
_NS = "_GLOBAL__N__c745f6a7_6_box_cu_82952795"


def mangle(form: str) -> str:
    """The Itanium-mangled name nvcc gives the instantiation ``form`` in
    the unnamed namespace every ``csrc/`` kernel lives in (a repeated
    element type is a substitution, ``S1_``)."""
    name, _, rest = form.partition("<")
    head = f"_ZN{len(_NS)}{_NS}{len(name)}{name}"
    if not rest:
        return f"{head}EPKhPhlii"
    args, seen = "", set()
    for a in (x.strip() for x in rest.rstrip(">").split(",")):
        if a in _CODES:
            args += "S1_" if a in seen and a.startswith("__") else _CODES[a]
            seen.add(a)
        elif a in ("true", "false"):
            args += f"Lb{int(a == 'true')}E"
        else:
            args += f"Li{a}E"
    args += next((v for k, v in _TRAILING.items() if k in name), "")
    return f"{head}I{args}EEvPKT_PS2_ii"


@pytest.fixture
def toolchain(monkeypatch, tmp_path):
    """A stand-in nvcc (writes the source's name into the library) and
    cuobjdump (lists the instantiations of every case of that source);
    ``state["fail"]`` names a source whose nvcc fails, ``state["drop"]``
    an instantiation cuobjdump leaves out. Returns (state, calls)."""
    state = {"fail": None, "drop": None}
    calls = []
    forms = {}
    for c in CASES:
        if c.name not in aot.REFUSED:
            forms.setdefault(c.source, set()).update(aot.check_case(c))

    def run(cmd, **kwargs):
        calls.append(list(cmd))
        tool = Path(cmd[0]).name
        if tool == "nvcc":
            src = Path(cmd[-1])
            if src.name == state["fail"]:
                return subprocess.CompletedProcess(
                    cmd, 1, stdout=f"{src.name}(1): error: stand-in\n")
            Path(cmd[cmd.index("-o") + 1]).write_text(src.name)
            return subprocess.CompletedProcess(cmd, 0, stdout="")
        assert tool == "cuobjdump" and cmd[1] == "-sass"
        names = [mangle(f) for f in sorted(forms[Path(cmd[2]).read_text()])
                 if f != state["drop"]]
        return subprocess.CompletedProcess(cmd, 0, stdout="".join(
            f"\n\tFunction : {n}\n\t.headerflags @\"EF_CUDA_SM90\"\n"
            "        /*0000*/ LDC R1, c[0x0][0x28] ;\n" for n in names))

    monkeypatch.setattr(subprocess, "run", run)
    aot._sass.cache_clear()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: str(tmp_path / "bin" / "nvcc"))
    return state, calls


def _nvcc_calls(calls):
    return [c for c in calls if Path(c[0]).name == "nvcc"]


def test_stand_in_build_runs_one_nvcc_a_source_with_the_flags(toolchain):
    state, calls = toolchain
    result = aot.compile_all_kernels()
    assert result == {n: ("ok" if n not in aot.REFUSED else result[n])
                      for n in NAMES}
    for name in aot.REFUSED:
        assert result[name].startswith("error: ") and "shared memory" in \
            result[name]
    nvcc = _nvcc_calls(calls)
    assert sorted(Path(c[-1]).name for c in nvcc) == sorted(_build.SOURCES)
    for cmd in nvcc:
        assert cmd[1:1 + len(_build.NVCC_FLAGS)] == list(_build.NVCC_FLAGS)
        assert "-gencode=arch=compute_90a,code=sm_90a" in cmd
        assert "-fmad=false" in cmd
    assert len(calls) == 2 * len(_build.SOURCES)  # one cuobjdump a library
    # the target cache: a second check compiles nothing, and reads each
    # library's machine code once
    calls.clear()
    assert aot.compile_all_kernels() == result
    assert calls == []


@pytest.mark.parametrize("source", ["box.cu", "membw.cu", "multi.cu"])
def test_a_failing_source_fails_its_own_cases_only(toolchain, source):
    state, _ = toolchain
    state["fail"] = source
    result = aot.compile_all_kernels()
    for case in CASES:
        verdict = result[case.name]
        if case.name in aot.REFUSED:  # its wrapper's checks come first
            assert verdict.startswith("error: ") and "shared memory" in \
                verdict
        elif case.source == source:
            assert verdict.startswith(f"error: {source} (exit 1)"), verdict
        else:
            assert verdict == "ok", (case.name, verdict)
    built = _build.build_sources()
    assert isinstance(built[Path(source).stem], RuntimeError)
    with pytest.raises(RuntimeError, match=f"nvcc failed for {source}"):
        _build.libraries.__wrapped__()


def test_an_instantiation_missing_from_the_machine_code_fails_its_case(
        toolchain):
    state, _ = toolchain
    state["drop"] = "stencil27_wave_kernel<__nv_bfloat16, 8>"
    result = aot.compile_all_kernels()
    assert result["stencil27.pallas_wave.bf16.full"] == (
        "error: wave.cu holds no stencil27_wave_kernel<__nv_bfloat16, 8>")
    assert result["stencil27.pallas_wave.full"] == "ok"


@pytest.mark.parametrize("form,mangled,hit", [
    ("jacobi1d_kernel<float, false, false>",
     "_ZN12_GLOBAL__N_115jacobi1d_kernelIfLb0ELb0EEEvPKT_PS1_x", True),
    ("jacobi1d_kernel<float, false, true>",
     "_ZN12_GLOBAL__N_115jacobi1d_kernelIfLb0ELb0EEEvPKT_PS1_x", False),
    ("jacobi1d_kernel<float, false, false>",
     "_ZN12_GLOBAL__N_121jacobi1d_multi_kernelIffLb0EEEvPKT_PT0_x", False),
    ("jacobi1d_multi_kernel<__nv_bfloat16, __nv_bfloat16, false>",
     "_ZN12_GLOBAL__N_121jacobi1d_multi_kernelI13__nv_bfloat16S1_Lb0EEEvPKT_",
     True),
    ("jacobi3d_multi_kernel<__half, float, 4>",
     "_ZN12_GLOBAL__N_121jacobi3d_multi_kernelI6__halffLi4EEEvPKT_PT0_iii",
     True),
    ("jacobi3d_multi_kernel<__half, float, 4>",
     "_ZN12_GLOBAL__N_121jacobi3d_multi_kernelI6__halffLi2EEEvPKT_PT0_iii",
     False),
    ("membw_stream<uint32_t>",
     "_ZN12_GLOBAL__N_120membw_stream_inplaceIjLb1EEEvPKT_", False),
    ("membw_stream_inplace<uint32_t>",
     "_ZN12_GLOBAL__N_120membw_stream_inplaceIjLb1EEEvPKT_", True),
    ("membw_dma", "_ZN12_GLOBAL__N_19membw_dmaEPKhPhlii", True),
    ("membw_dma", "_Z9membw_dmaPKhPhlii", True),
    ("membw_dma", "_ZN12_GLOBAL__N_19membw_dmaIfEEvv", False),
    ("pack_faces_kernel<uint16_t>",
     "_ZN12_GLOBAL__N_117pack_faces_kernelItLb0EEEvPKT_", True),
    ("pack_faces_kernel<uint16_t>",
     "_ZN12_GLOBAL__N_117pack_faces_kernelIjLb0EEEvPKT_", False),
    ("stencil9_block_kernel<float, false>",
     f"_ZN{len(_NS)}{_NS}21stencil9_block_kernelIfLb0ELi4EEEvPKT_", True),
    ("membw_dma", f"_ZN{len(_NS)}{_NS}9membw_dmaEPKhPhlii", True),
])
def test_sass_pattern_finds_exactly_its_instantiation(form, mangled, hit):
    import re

    assert bool(re.search(aot.sass_pattern(form), mangled)) is hit


def test_resource_usage_and_kernel_names_from_cuobjdump(monkeypatch,
                                                        tmp_path):
    text = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _ZN12_GLOBAL__N_117pack_faces_kernelIjLb1EEEvPKT_PS1_:
  REG:32 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:960 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z14multi2d_kernelIffLb0ELb0EEvPKT_PT0_iiiiii:
  REG:168 STACK:16 SHARED:1024 LOCAL:24 CONSTANT[0]:936 TEXTURE:0 SURFACE:0 SAMPLER:0
"""
    seen = []

    def run(cmd, **kwargs):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=text)

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: str(tmp_path / "bin" / "nvcc"))
    table = aot.resource_usage(tmp_path / "libx.so")
    assert seen == [[str(tmp_path / "bin" / "cuobjdump"),
                     "--dump-resource-usage", str(tmp_path / "libx.so")]]
    assert table == {
        "_ZN12_GLOBAL__N_117pack_faces_kernelIjLb1EEEvPKT_PS1_": {
            "registers": 32, "shared": 0, "local": 0, "stack": 0},
        "_Z14multi2d_kernelIffLb0ELb0EEvPKT_PT0_iiiiii": {
            "registers": 168, "shared": 1024, "local": 24, "stack": 16},
    }
    assert [aot.kernel_name(n) for n in table] == ["pack_faces_kernel",
                                                   "multi2d_kernel"]
    assert aot.kernel_name("_Z9membw_dmaPKhPhlii") == "membw_dma"
    assert aot.kernel_name(mangle("jacobi3d_kernel<float, true>")) == \
        "jacobi3d_kernel"
    assert aot.kernel_name(mangle("membw_dma")) == "membw_dma"
