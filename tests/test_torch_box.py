"""The port's box stencils (2D 9-point, 3D 27-point) held against the JAX
package's, on the CPU: the golden copies, the kernels' plain versions
against the Pallas kernels (interpret mode, as the JAX package's own
tests run them), and the single-device driver, its ``--tol`` mode, its
rows and its CLI.

Inputs are seeded NumPy fields. Tolerances:
- golden copies: bitwise (the same NumPy expressions);
- ``step_plain`` against ``step_pallas`` (whole field) in float32,
  bfloat16 and float16, and against ``step_pallas_stream``: bitwise
  (both compute in float32 and narrow once), except the 9-point stream
  in bfloat16/float16 periodic runs. There JAX recomputes rows 0 and
  ny-1 outside its kernel in the field's dtype (``_edge_row``, ROADMAP
  Trap 4): three levels of rounded adds, each off by at most half an
  ulp of its partial sums (together at most 1 ulp of the total per
  level, the values being non-negative), then an exact multiply by 1/8,
  against the port's one rounding of the float32 sum: at most 3.5 ulps,
  so those two rows are held to 4 ulps and every other row is bitwise.
  After 4 steps those runs are held to the JAX driver's envelope;
- the driver against the JAX driver: bitwise dumps in float32.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_comm.analysis.rowschema import validate_row
from tpu_comm.bench import stencil as jstencil
from tpu_comm.bench.stencil import _check_against_golden
from tpu_comm.kernels import reference as jref
from tpu_comm.kernels import stencil9 as j9
from tpu_comm.kernels import stencil27 as j27
from tpu_comm_torch import cli
from tpu_comm_torch.bench import stencil as pstencil
from tpu_comm_torch.kernels import kernels_for
from tpu_comm_torch.kernels import reference as pref
from tpu_comm_torch.kernels import stencil9 as p9
from tpu_comm_torch.kernels import stencil27 as p27
from tpu_comm_torch.kernels.tiling import from_numpy_field, to_numpy_field

ROOT = Path(__file__).resolve().parents[1]
#: points -> (JAX module, port module, aligned shape, the JAX stream chunk)
FAMILIES = {
    9: (j9, p9, (16, 256), {"rows_per_chunk": 8}),
    27: (j27, p27, (8, 16, 128), {"planes_per_chunk": 2}),
}
DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
    "float16": (jnp.float16, torch.float16),
}
UINT = {4: np.uint32, 2: np.uint16}
#: the Trap-4 bound on the 9-point stream's edge rows (module docstring)
EDGE_ULPS = 4
#: shapes the TPU arms refuse (not tile-aligned); the port takes them
ODD = {9: (30, 50), 27: (5, 7, 9)}


def _field(shape, kind="random", seed=7) -> np.ndarray:
    return jref.init_field(shape, np.float32, kind=kind, seed=seed)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(UINT[a.dtype.itemsize]).astype(
        np.int64)


def _port_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).astype(np.int64)
    return _bits(t.numpy())


def _both(u_np, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(u_np).astype(jdt), from_numpy_field(u_np, "cpu", tdt)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("points", [9, 27])
def test_golden_copy_equals_jax_package_golden(points, bc, dtype):
    """Steps, runs and the convergence loop with ``step=``: bitwise."""
    step, run = pref.GOLDEN_STEPS[points], pref.GOLDEN_RUNS[points]
    jstep = {9: jref.jacobi9_step, 27: jref.jacobi27_step}[points]
    jrun = {9: jref.jacobi9_run, 27: jref.jacobi27_run}[points]
    u = pref.init_field(ODD[points], dtype, kind="random", seed=3)
    np.testing.assert_array_equal(step(u, bc=bc), jstep(u, bc=bc))
    np.testing.assert_array_equal(run(u, 5, bc=bc), jrun(u, 5, bc=bc))
    h = pref.init_field(ODD[points], dtype)
    pu, pit, pres = pref.jacobi_run_to_convergence(h, 0.1, 400, 3, bc=bc,
                                                   step=step)
    ju, jit_, jres = jref.jacobi_run_to_convergence(h, 0.1, 400, 3, bc=bc,
                                                    step=jstep)
    assert (pit, pres) == (jit_, jres) and 3 < pit < 400
    np.testing.assert_array_equal(pu, ju)


def test_golden_refuses_the_wrong_rank():
    with pytest.raises(ValueError, match="needs a 2D field"):
        pref.jacobi9_step(np.zeros((3, 3, 3), np.float32))
    with pytest.raises(ValueError, match="needs a 3D field"):
        pref.jacobi27_step(np.zeros((3, 3), np.float32))


@pytest.mark.parametrize("kind", ["random", "hot-boundary"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("points", [9, 27])
def test_block_arm_matches_jax_whole_field_kernel_bitwise(points, bc, dtype,
                                                          kind):
    jmod, pmod, shape, _ = FAMILIES[points]
    uj, ut = _both(_field(shape, kind), dtype)
    want = jmod.step_pallas(uj, bc=bc, interpret=True)
    got = pmod.step_block(ut, bc=bc)
    np.testing.assert_array_equal(_port_bits(got), _bits(np.asarray(want)))
    want4 = jmod.run(uj, 4, bc=bc, impl="pallas", interpret=True)
    got4 = pmod.run(ut, 4, bc=bc, impl="block")
    np.testing.assert_array_equal(_port_bits(got4), _bits(np.asarray(want4)))


@pytest.mark.parametrize("kind", ["random", "hot-boundary"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("points", [9, 27])
def test_stream_arm_matches_jax_stream_kernel(points, bc, dtype, kind):
    jmod, pmod, shape, chunk = FAMILIES[points]
    uj, ut = _both(_field(shape, kind), dtype)
    want = _bits(np.asarray(jmod.step_pallas_stream(
        uj, bc=bc, interpret=True, **chunk)))
    got = _port_bits(pmod.step_stream(ut, bc=bc, **chunk))
    edge = np.zeros(shape, dtype=bool)
    if points == 9 and bc == "periodic" and dtype != "float32":
        edge[[0, -1], :] = True
    np.testing.assert_array_equal(got[~edge], want[~edge])
    # fields are non-negative, so the ulp distance is the bit distance
    assert np.abs(got[edge] - want[edge]).max(initial=0) <= EDGE_ULPS
    want4 = np.asarray(jmod.run(uj, 4, bc=bc, impl="pallas-stream",
                                interpret=True, **chunk))
    got4 = pmod.run(ut, 4, bc=bc, **chunk)
    if edge.any():
        _check_against_golden(to_numpy_field(got4),
                              want4.astype(np.float32), dtype, iters=4)
    else:
        np.testing.assert_array_equal(_port_bits(got4), _bits(want4))


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("points", [9, 27])
def test_odd_shapes_match_jax_lax_arm_and_golden(points, bc):
    """Shapes the TPU arms refuse, in float32: both port arms bitwise
    against the JAX lax arm and the golden after 1 and 4 steps."""
    jmod, pmod, _, _ = FAMILIES[points]
    u = _field(ODD[points])
    ut = from_numpy_field(u, "cpu")
    for impl in ("stream", "block"):
        got1 = pmod.STEPS[impl](ut, bc=bc).numpy()
        np.testing.assert_array_equal(
            got1, np.asarray(jmod.step_lax(jnp.asarray(u), bc=bc)))
        np.testing.assert_array_equal(got1, pref.GOLDEN_STEPS[points](u, bc))
        got4 = pmod.run(ut, 4, bc=bc, impl=impl).numpy()
        np.testing.assert_array_equal(
            got4, pref.GOLDEN_RUNS[points](u, 4, bc=bc))


@pytest.mark.parametrize("arm", ["step_stream", "step_block"])
@pytest.mark.parametrize("points", [9, 27])
def test_wrappers_on_cpu_run_the_plain_version_and_never_fall_back(points,
                                                                   arm):
    """A CPU tensor runs ``step_plain`` into ``out`` without counting a
    launch; a tensor on neither the CPU nor a card is refused."""
    pmod = FAMILIES[points][1]
    ut = from_numpy_field(_field(ODD[points]), "cpu")
    out = torch.empty_like(ut)
    wrapper = getattr(pmod, arm)
    before = wrapper.launches
    assert wrapper(ut, bc="periodic", out=out) is out
    assert torch.equal(out, pmod.step_plain(ut, bc="periodic"))
    assert wrapper.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        wrapper(torch.empty(ODD[points], device="meta"))
    with pytest.raises(ValueError, match="bc must be one of"):
        wrapper(ut, bc="neumann")


def test_kernels_for_dispatches_and_refuses_as_jax_does():
    assert kernels_for(2, 9) is p9 and kernels_for(3, 27) is p27
    assert kernels_for(2).__name__.endswith("jacobi2d")
    for dim, points in ((3, 9), (2, 27), (2, 5)):
        with pytest.raises(ValueError) as port:
            kernels_for(dim, points)
        with pytest.raises(ValueError) as ref:
            jstencil._kernels_for(jstencil.StencilConfig(dim=dim,
                                                         points=points))
        assert str(port.value) == str(ref.value)


def _port_cfg(**kw):
    return pstencil.StencilConfig(backend="cpu", warmup=1, reps=1, **kw)


#: points -> (dim, size, the JAX stream chunk / the port's, a --tol the
#: hot-boundary field reaches in 5 to 200 steps)
DRIVER = {9: (2, 128, 16, 0.3), 27: (3, 128, 8, 10.0)}


@pytest.mark.parametrize("impl", ["stream", "block"])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("points", [9, 27])
def test_driver_dump_matches_jax_driver(tmp_path, points, bc, impl):
    dim, size, chunk, _ = DRIVER[points]
    load = tmp_path / "u0.npy"
    np.save(load, _field((size,) * dim, seed=points))
    common = dict(dim=dim, points=points, size=size, iters=4, bc=bc,
                  load=str(load))
    jimpl = {"stream": "pallas-stream", "block": "pallas"}[impl]
    kw = {"chunk": chunk} if impl == "stream" else {}
    jstencil.run_single_device(jstencil.StencilConfig(
        impl=jimpl, backend="cpu-sim", warmup=1, reps=1,
        dump=str(tmp_path / "a.npy"), **common, **kw))
    path = tmp_path / "rows.jsonl"
    rec = pstencil.run_single_device(_port_cfg(
        impl=impl, dump=str(tmp_path / "b.npy"), verify=True,
        verify_iters=4, jsonl=str(path), **common, **kw))
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"),
                                  np.load(tmp_path / "a.npy"))
    tag = {9: "stencil2d-9pt", 27: "stencil3d-27pt"}[points]
    assert (rec["workload"], rec["impl"], rec["verified"]) == (tag, impl,
                                                               True)
    errors, warnings = validate_row(json.loads(path.read_text()))
    assert errors == [] and warnings == []


@pytest.mark.parametrize("points", [9, 27])
def test_tol_mode_stops_with_jax_driver_and_golden(tmp_path, points):
    dim, size, chunk, tol = DRIVER[points]
    common = dict(dim=dim, points=points, size=size, iters=200, tol=tol,
                  check_every=5)
    step = pref.GOLDEN_STEPS[points]
    _, want_iters, _ = pref.jacobi_run_to_convergence(
        pref.init_field((size,) * dim), tol, 200, check_every=5, step=step)
    assert 5 < want_iters < 200
    jrec = jstencil.run_single_device(jstencil.StencilConfig(
        impl="pallas-stream", backend="cpu-sim", warmup=1, reps=1,
        chunk=chunk, dump=str(tmp_path / "a.npy"), **common))
    path = tmp_path / "rows.jsonl"
    prec = pstencil.run_single_device(_port_cfg(
        verify=True, dump=str(tmp_path / "b.npy"), jsonl=str(path),
        **common))
    assert jrec["iters"] == prec["iters"] == want_iters
    assert prec["workload"] == jrec["workload"] == (
        f"stencil{dim}d-{points}pt-conv")
    assert prec["converged"] and prec["verified"]
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"),
                                  np.load(tmp_path / "a.npy"))
    errors, warnings = validate_row(json.loads(path.read_text()))
    assert errors == [] and warnings == []


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("points", [9, 27])
def test_sub_fp32_driver_verifies_against_golden(points, dtype):
    dim = DRIVER[points][0]
    rec = pstencil.run_single_device(_port_cfg(
        dim=dim, points=points, size=24, iters=4, dtype=dtype,
        bc="periodic", verify=True, verify_iters=10))
    assert rec["verified"] and rec["dtype"] == dtype


@pytest.mark.parametrize("argv,message", [
    (["--points", "9", "--dim", "3"],
     "--points 9 (the 2D box stencil) needs --dim 2"),
    (["--points", "27", "--dim", "2"],
     "--points 27 (the 3D box stencil) needs --dim 3"),
    (["--points", "9", "--dim", "2", "--impl", "wave", "--bc", "periodic"],
     "wave supports bc='dirichlet' only, as JAX's pallas-wave (its "
     "frozen edges are the TPU pipeline's junk barrier)"),
    (["--points", "27", "--dim", "3", "--impl", "overlap"],
     "--impl overlap is an arm of a mesh run: pass --mesh"),
    (["--points", "27", "--dim", "3", "--impl", "pallas"],
     "the port calls this arm 'block'"),
    (["--points", "27", "--dim", "3", "--mesh", "2,2,1", "--impl",
      "partitioned"], "stencil='27pt' supports impl='torch'|'overlap'|"),
    (["--points", "27", "--dim", "3", "--mesh", "2,2,1", "--pack", "kernel",
      "--impl", "block"],
     "pack='kernel' does not apply to the box stencils"),
    (["--points", "9", "--dim", "2", "--mesh", "2,2", "--impl", "block",
      "--pack", "kernel"], "pack='kernel' needs a 3D mesh"),
])
def test_cli_refuses_what_the_port_does_not_run(capsys, argv, message):
    rc = cli.main(["stencil", "--backend", "cpu", "--size", "16", "--iters",
                   "2", *argv])
    assert rc == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("argv,workload", [
    (["--points", "9", "--dim", "2", "--size", "64"], "stencil2d-9pt"),
    (["--points", "27", "--dim", "3", "--size", "24"], "stencil3d-27pt"),
])
def test_cli_runs_on_cpu(tmp_path, argv, workload):
    path = tmp_path / "rows.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "tpu_comm_torch", "stencil", "--backend",
         "cpu", *argv, "--iters", "4", "--verify", "--jsonl", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    row = json.loads(path.read_text())
    assert (row["workload"], row["platform"], row["verified"]) == (
        workload, "cpu", True)
    assert json.loads(res.stdout)["workload"] == workload
