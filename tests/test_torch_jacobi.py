"""The port's stencil steps held against the JAX package, on the CPU.

The same seeded NumPy fields go through ``tpu_comm``'s ``pallas-stream``
arm (Pallas in interpret mode, as the JAX package's own tests run it)
and through ``tpu_comm_torch``'s ``step_stream``/``run`` on CPU tensors,
which run the kernels' plain PyTorch versions.

The ``block`` arm (``step_block``, the port of the whole-field
``step_pallas`` kernels) is bitwise against ``step_pallas`` in every
dtype and bc: those kernels compute every cell in float32 and only copy
the dirichlet boundary back outside.

Contract of the stream arm: float32 is bitwise after 1 and 4 steps. bfloat16 and float16
are bitwise after one step except, for periodic runs, the cells the JAX
arm computes outside its kernel in the narrow dtype (the two 1D
endpoints, the 2D top and bottom rows), which stay within 2 ulps; after
4 steps a dirichlet run is still bitwise and a periodic one within the
JAX driver's verification envelope.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_comm.bench.stencil import _check_against_golden
from tpu_comm.kernels import jacobi1d as j1
from tpu_comm.kernels import jacobi2d as j2
from tpu_comm.kernels import jacobi3d as j3
from tpu_comm.kernels import reference as jref
from tpu_comm_torch.kernels import jacobi1d as p1
from tpu_comm_torch.kernels import jacobi2d as p2
from tpu_comm_torch.kernels import jacobi3d as p3
from tpu_comm_torch.kernels import reference as pref
from tpu_comm_torch.kernels.tiling import from_numpy_field, to_numpy_field

JAX = {1: j1, 2: j2, 3: j3}
PORT = {1: p1, 2: p2, 3: p3}
SHAPES = {1: (8192,), 2: (64, 256), 3: (8, 16, 128)}
#: sizes the TPU stream arm refuses (not tile-aligned); the port takes them
ODD_SHAPES = {1: (1000,), 2: (30, 50), 3: (5, 7, 9)}
CHUNK = {
    1: {"rows_per_chunk": 8},
    2: {"rows_per_chunk": 16},
    3: {"planes_per_chunk": 2},
}
DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
    "float16": (jnp.float16, torch.float16),
}
UINT = {4: np.uint32, 2: np.uint16}


def _field(shape, kind: str) -> np.ndarray:
    return jref.init_field(shape, np.float32, kind=kind, seed=7)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(UINT[a.dtype.itemsize]).astype(
        np.int64
    )


def _port_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).astype(np.int64)
    return _bits(t.numpy())


def _edge_mask(dim: int, shape, dtype: str, bc: str) -> np.ndarray:
    """Cells the JAX stream arm computes outside its kernel in the narrow
    dtype (periodic sub-fp32 only)."""
    mask = np.zeros(shape, dtype=bool)
    if bc == "periodic" and dtype != "float32":
        if dim == 1:
            mask[[0, -1]] = True
        elif dim == 2:
            mask[[0, -1], :] = True
    return mask


def _both(dim, dtype, u_np):
    jdt, tdt = DTYPES[dtype]
    uj = jnp.asarray(u_np).astype(jdt)
    ut = from_numpy_field(u_np, "cpu", tdt)
    np.testing.assert_array_equal(_bits(np.asarray(uj)), _port_bits(ut))
    return uj, ut


@pytest.mark.parametrize("kind", ["random", "hot-boundary"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_one_step_matches_jax_stream_arm(dim, bc, dtype, kind):
    shape = SHAPES[dim]
    uj, ut = _both(dim, dtype, _field(shape, kind))
    want = _bits(np.asarray(JAX[dim].step_pallas_stream(
        uj, bc=bc, interpret=True, **CHUNK[dim]
    )))
    got = _port_bits(PORT[dim].step_stream(ut, bc=bc, **CHUNK[dim]))
    edge = _edge_mask(dim, shape, dtype, bc)
    np.testing.assert_array_equal(got[~edge], want[~edge])
    # fields are non-negative, so the ulp distance is the bit distance
    assert np.abs(got[edge] - want[edge]).max(initial=0) <= 2


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_four_steps_match_jax_stream_arm(dim, bc, dtype):
    uj, ut = _both(dim, dtype, _field(SHAPES[dim], "random"))
    want = np.asarray(JAX[dim].run(
        uj, 4, bc=bc, impl="pallas-stream", interpret=True, **CHUNK[dim]
    ))
    got_t = PORT[dim].run(ut, 4, bc=bc, **CHUNK[dim])
    if dtype == "float32" or bc == "dirichlet" or dim == 3:
        np.testing.assert_array_equal(_port_bits(got_t), _bits(want))
    else:
        _check_against_golden(
            to_numpy_field(got_t), want.astype(np.float32), dtype, iters=4
        )


@pytest.mark.parametrize("kind", ["random", "hot-boundary"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_block_arm_matches_jax_whole_field_arm_bitwise(dim, bc, dtype, kind):
    uj, ut = _both(dim, dtype, _field(SHAPES[dim], kind))
    want1 = JAX[dim].step_pallas(uj, bc=bc, interpret=True)
    got1 = PORT[dim].step_block(ut, bc=bc)
    np.testing.assert_array_equal(_port_bits(got1), _bits(np.asarray(want1)))
    want4 = JAX[dim].run(uj, 4, bc=bc, impl="pallas", interpret=True)
    got4 = PORT[dim].run(ut, 4, bc=bc, impl="block")
    np.testing.assert_array_equal(_port_bits(got4), _bits(np.asarray(want4)))


@pytest.mark.parametrize("kind", ["random", "hot-boundary"])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_odd_sizes_match_step_lax_and_golden(dim, bc, kind):
    """Sizes the TPU stream arm refuses, in float32: bitwise against the
    JAX lax arm and the golden, after 1 and 4 steps."""
    u = _field(ODD_SHAPES[dim], kind)
    ut = from_numpy_field(u, "cpu")
    got1 = PORT[dim].step_stream(ut, bc=bc).numpy()
    np.testing.assert_array_equal(
        got1, np.asarray(JAX[dim].step_lax(jnp.asarray(u), bc=bc))
    )
    np.testing.assert_array_equal(got1, jref.jacobi_step(u, bc=bc))
    got4 = PORT[dim].run(ut, 4, bc=bc).numpy()
    np.testing.assert_array_equal(
        got4, np.asarray(JAX[dim].run(jnp.asarray(u), 4, bc=bc, impl="lax"))
    )
    np.testing.assert_array_equal(got4, jref.jacobi_run(u, 4, bc=bc))
    np.testing.assert_array_equal(
        PORT[dim].run(ut, 4, bc=bc, impl="block").numpy(), got4
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_golden_copy_equals_jax_package_golden(dim, bc, dtype):
    shape = ODD_SHAPES[dim]
    for kind in ("random", "hot-boundary"):
        np.testing.assert_array_equal(
            pref.init_field(shape, dtype, kind=kind, seed=3),
            jref.init_field(shape, dtype, kind=kind, seed=3),
        )
    u = pref.init_field(shape, dtype, kind="random", seed=3)
    np.testing.assert_array_equal(
        pref.jacobi_step(u, bc=bc), jref.jacobi_step(u, bc=bc)
    )
    np.testing.assert_array_equal(
        pref.jacobi_run(u, 5, bc=bc), jref.jacobi_run(u, 5, bc=bc)
    )
    assert pref.residual(u, bc=bc) == jref.residual(u, bc=bc)
    h = pref.init_field(shape, dtype)
    pu, pit, pres = pref.jacobi_run_to_convergence(h, 0.05, 200, 3, bc=bc)
    ju, jit_, jres = jref.jacobi_run_to_convergence(h, 0.05, 200, 3, bc=bc)
    assert (pit, pres) == (jit_, jres)
    np.testing.assert_array_equal(pu, ju)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_stream_wrapper_on_cpu_runs_plain_version_into_out(dim):
    ut = from_numpy_field(_field(ODD_SHAPES[dim], "random"), "cpu")
    out = torch.empty_like(ut)
    before = PORT[dim].step_stream.launches
    got = PORT[dim].step_stream(ut, bc="periodic", out=out)
    assert got is out
    assert torch.equal(out, PORT[dim].step_plain(ut, bc="periodic"))
    assert PORT[dim].step_stream.launches == before


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_block_wrapper_on_cpu_runs_plain_version_into_out(dim):
    ut = from_numpy_field(_field(ODD_SHAPES[dim], "random"), "cpu")
    out = torch.empty_like(ut)
    before = PORT[dim].step_block.launches
    got = PORT[dim].step_block(ut, bc="periodic", out=out)
    assert got is out
    assert torch.equal(out, PORT[dim].step_plain(ut, bc="periodic"))
    assert PORT[dim].step_block.launches == before
    assert PORT[dim].STEPS == {"stream": PORT[dim].step_stream,
                               "block": PORT[dim].step_block}


@pytest.mark.parametrize("arm", ["step_stream", "step_block"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_stream_wrapper_never_falls_back_off_the_cpu(dim, arm):
    """A tensor that is neither on the CPU nor on a CUDA card is refused,
    not quietly run through the plain version."""
    u = torch.empty(ODD_SHAPES[dim], device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(PORT[dim], arm)(u)


def test_bad_bc_is_refused():
    with pytest.raises(ValueError, match="bc must be one of"):
        p1.step_stream(torch.zeros(8), bc="neumann")
