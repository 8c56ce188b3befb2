"""The port's face pack held against the JAX package's, on the CPU.

The same seeded block goes through ``tpu_comm.kernels.pack`` (the Pallas
kernel in interpret mode, as the JAX package's own tests run it) and
through ``tpu_comm_torch.kernels.pack`` on a CPU tensor, which runs the
kernel's plain PyTorch version. A pack moves bits, so every face is
bitwise equal in float32, bfloat16 and float16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_comm.kernels import pack as jpack
from tpu_comm.kernels import reference as jref
from tpu_comm_torch.kernels import pack as ppack
from tpu_comm_torch.kernels.tiling import from_numpy_field, to_numpy_field

DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
    "float16": (jnp.float16, torch.float16),
}
#: blocks the TPU kernel accepts (lane-aligned nx, whole-ny or 128-row y
#: blocks)
SHAPES = [(8, 16, 128), (4, 8, 128), (16, 128, 128)]


def _block(shape):
    return jref.init_field(shape, np.float32, kind="random", seed=11)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("impl", ["fused", "kernel"])
def test_faces_equal_jax_bitwise(impl, shape, dtype):
    jdt, tdt = DTYPES[dtype]
    u = _block(shape)
    want = jpack.pack_faces_3d(
        jnp.asarray(u).astype(jdt),
        impl={"fused": "lax", "kernel": "pallas"}[impl], interpret=True,
    )
    got = ppack.pack_faces_3d(from_numpy_field(u, "cpu", tdt), impl=impl)
    assert len(got) == len(want) == len(ppack.FACE_NAMES) == 6
    for name, g, w in zip(ppack.FACE_NAMES, got, want):
        assert g.dtype == tdt, name
        np.testing.assert_array_equal(
            to_numpy_field(g), np.asarray(w.astype(jnp.float32)), name
        )


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 5, 7), (2, 9, 4)])
def test_any_shape_packs_and_the_strided_faces_are_contiguous(shape):
    """Shapes the TPU kernel refuses (not lane-aligned); the port takes
    any block."""
    u = from_numpy_field(_block(shape), "cpu")
    y_lo, y_hi, x_lo, x_hi = ppack.pack_faces(u)
    for face, want in ((y_lo, u[:, 0, :]), (y_hi, u[:, -1, :]),
                       (x_lo, u[:, :, 0]), (x_hi, u[:, :, -1])):
        assert face.is_contiguous() and torch.equal(face, want)
    assert ppack.FACE_NAMES == jpack.FACE_NAMES


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    u = from_numpy_field(_block((4, 6, 8)), "cpu")
    before = ppack.pack_faces.launches
    got = ppack.pack_faces(u)
    assert ppack.pack_faces.launches == before
    for g, w in zip(got, ppack.pack_faces_plain(u)):
        assert torch.equal(g, w)


def test_wrapper_never_falls_back_off_the_cpu():
    with pytest.raises(ValueError, match="CUDA tensor"):
        ppack.pack_faces(torch.empty((4, 6, 8), device="meta"))


def test_bad_input_is_refused():
    u = from_numpy_field(_block((4, 6, 8)), "cpu")
    with pytest.raises(ValueError, match="3-D block"):
        ppack.pack_faces(u[0])
    with pytest.raises(ValueError, match="unknown pack impl"):
        ppack.pack_faces_3d(u, impl="pallas")
    with pytest.raises(ValueError, match="unknown pack impl"):
        jpack.pack_faces_3d(jnp.asarray(u.numpy()), impl="kernel")


# --- the kernel's grid (pack_plan) -----------------------------------------

@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("shape", [(512, 512, 512), (1, 1, 1), (3, 5, 7),
                                   (130, 9, 33), (5, 7, 64), (7, 300, 1),
                                   (9, 1, 300), (70000, 3, 5), (66000, 2, 8),
                                   (1 << 20, 2, 2)])
def test_pack_plan_fits_the_card_and_counts_every_item(shape, sms):
    """The grid fits a launch, and its warps, striding, reach every work
    item of ``csrc/pack.cu``: the x chunks of 32 flat rows, one a lane,
    and the 2 nz y rows."""
    nz, ny, _ = shape
    blocks = ppack.pack_plan(shape, sms)
    assert ppack.PACK_THREADS <= 1024 and ppack.PACK_THREADS % 32 == 0
    assert 1 <= blocks <= sms * ppack.BLOCKS_PER_SM
    items = -(-nz * ny // 32) + 2 * nz
    warps = blocks * ppack.PACK_THREADS // 32
    # never a block without an item; fewer warps than items only where the
    # grid is full, and the grid-stride loop then takes the rest
    assert warps - ppack.PACK_THREADS // 32 < items
    if warps < items:
        assert blocks == sms * ppack.BLOCKS_PER_SM


def test_pack_plan_at_512_cubed_on_the_h100():
    """132 SMs: 8192 x chunks and 1024 y rows dealt to 528 blocks (4 an
    SM) of 8 warps, which stride; a 64^3 block needs 32 blocks."""
    assert ppack.pack_plan((512, 512, 512), 132) == 528
    assert ppack.pack_plan((64, 64, 64), 132) == 32


def test_pack_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="sms"):
        ppack.pack_plan((4, 4, 4), 0)


# --- the launch path every wrapper goes through ----------------------------

class _FakeLib:
    """A built library as ctypes shows it: its exported launchers as
    attributes, and ``tc_error_string``."""

    def __init__(self, **symbols):
        self.lookups = 0
        self._symbols = symbols

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        self.lookups += 1
        if name == "tc_error_string":
            return lambda code: f"fake error {code}".encode()
        if name not in self._symbols:
            raise AttributeError(name)
        return self._symbols[name]


@pytest.fixture
def fake_libs(monkeypatch):
    from tpu_comm_torch.kernels import _build

    calls = []
    libs = {
        "a": _FakeLib(tc_one=lambda *a: calls.append(("a", a)) or 0),
        "b": _FakeLib(tc_two=lambda *a: calls.append(("b", a)) or 0,
                      tc_bad=lambda *a: 7),
    }
    monkeypatch.setattr(_build, "libraries", lambda: libs)
    _build._entry.cache_clear()
    yield _build, libs, calls
    _build._entry.cache_clear()


def test_launch_resolves_a_symbol_once_to_the_library_exporting_it(fake_libs):
    _build, libs, calls = fake_libs
    _build.launch("tc_two", 1, 2)
    looked = libs["a"].lookups + libs["b"].lookups
    _build.launch("tc_two", 3, 4)
    _build.launch("tc_one", 5)
    assert calls == [("b", (1, 2)), ("b", (3, 4)), ("a", (5,))]
    # the second tc_two launch looked nothing up
    assert libs["a"].lookups + libs["b"].lookups == looked + 2
    assert _build._entry.cache_info().hits == 1


def test_launch_of_a_symbol_no_library_exports_raises(fake_libs):
    _build, _, calls = fake_libs
    for _ in range(2):
        with pytest.raises(RuntimeError,
                           match="no built library exports tc_missing"):
            _build.launch("tc_missing", 1)
    assert calls == []


def test_a_refused_launch_raises_with_the_library_message(fake_libs):
    _build, _, _ = fake_libs
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"tc_bad launch failed: "
                           r"CUDA error 7 \(fake error 7\)"):
            _build.launch("tc_bad")


class _OnDevice:
    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index


@pytest.mark.parametrize("current,index", [(0, 0), (1, 1), (0, 1)])
def test_launch_kernel_enters_a_device_only_when_it_is_not_current(
        monkeypatch, current, index):
    from tpu_comm_torch.kernels import tiling

    entered, launched = [], []

    class _Device:
        def __init__(self, i):
            self.i = i

        def __enter__(self):
            entered.append(self.i)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda i: 1000 + i, raising=False)
    monkeypatch.setattr(tiling, "launch",
                        lambda *a: launched.append(a))
    tiling.launch_kernel("tc_sym", _OnDevice(index), 11, 12)
    assert launched == [("tc_sym", 11, 12, 1000 + index)]
    assert entered == ([] if current == index else [index])
