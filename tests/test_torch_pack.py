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
