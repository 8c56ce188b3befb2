"""The rest of the port's single-device arms of the 1D and 2D star (and
the ``torch`` arm of every stencil) held against the JAX package, on the
CPU: ``grid`` against ``pallas-grid``, ``wave`` against ``pallas-wave``,
``stream2`` against ``pallas-stream2`` (Pallas in interpret mode, as the
JAX package's own tests run it; the port's wrappers run their plain
versions on a CPU tensor) and ``torch`` against ``lax``; then the driver,
its rows, ragged shapes against the golden, the refusals and the CLI.

Inputs are seeded NumPy fields, the same values to both packages.
Tolerances:
- ``grid``, ``stream2``: bitwise in float32. In bfloat16 and float16
  bitwise except where JAX fixes cells outside its kernel in the field's
  dtype (ROADMAP Trap 4): under periodic the two 1D endpoints
  (``_fix_global_endpoints``) and the 2D ``grid`` arm's top and bottom
  rows. There JAX rounds each add to the narrow dtype, the port rounds
  the float32 sum once: at most 2 ulps apart (the star's bound, as
  ``tests/test_torch_jacobi.py`` holds the ``stream`` arm). Under
  dirichlet those cells are frozen: bitwise.
- ``wave``: bitwise in float32, bfloat16 and float16 (JAX computes every
  cell in its kernel in float32 and narrows once, as the port does).
- ``torch``: bitwise against ``step_lax`` for all five stencils, both bcs,
  float32, bfloat16 and float16: both round every add to the field's
  dtype in the golden's association, with the constant rounded to it.
- ragged shapes (which the TPU arms refuse) against the NumPy golden: the
  kernel arms bitwise in float32, as the golden computes in float32.
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
from tpu_comm.kernels import jacobi1d as j1
from tpu_comm.kernels import jacobi2d as j2
from tpu_comm.kernels import jacobi3d as j3
from tpu_comm.kernels import reference as jref
from tpu_comm.kernels import stencil9 as j9
from tpu_comm.kernels import stencil27 as j27
from tpu_comm_torch import cli
from tpu_comm_torch.bench import JAX_STENCIL_IMPLS
from tpu_comm_torch.bench import stencil as pstencil
from tpu_comm_torch.kernels import jacobi1d as p1
from tpu_comm_torch.kernels import jacobi2d as p2
from tpu_comm_torch.kernels import jacobi3d as p3
from tpu_comm_torch.kernels import kernels_for
from tpu_comm_torch.kernels import reference as pref
from tpu_comm_torch.kernels import stencil9 as p9
from tpu_comm_torch.kernels import stencil27 as p27
from tpu_comm_torch.kernels.tiling import from_numpy_field
from torch_fake_clock import PER_ITER_S, fake_clock

ROOT = Path(__file__).resolve().parents[1]
JAX = {1: j1, 2: j2}
PORT = {1: p1, 2: p2}
#: tile-aligned shapes the TPU arms take, and the chunks that cross their
#: chunk seams
SHAPES = {1: (8192,), 2: (64, 256)}
CHUNKS = {1: [8], 2: [8, 16]}
DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
    "float16": (jnp.float16, torch.float16),
}
UINT = {4: np.uint32, 2: np.uint16}
#: the Trap-4 bound on the cells JAX fixes outside its kernel (the star)
EDGE_ULPS = 2
#: the new arms: port name -> (the JAX step, the dims it runs)
ARMS = {
    "grid": ("step_pallas_grid", (1, 2)),
    "wave": ("step_pallas_wave", (1, 2)),
    "stream2": ("step_pallas_stream2", (1,)),
}
#: every stencil's step_torch against JAX's step_lax: key -> (JAX module,
#: port module, a small shape)
TORCH_FAMILIES = {
    1: (j1, p1, (1000,)),
    2: (j2, p2, (37, 45)),
    3: (j3, p3, (7, 9, 11)),
    9: (j9, p9, (30, 50)),
    27: (j27, p27, (6, 7, 9)),
}
#: shapes the TPU arms refuse (not tile-aligned); the port takes them
RAGGED = {1: [(3,), (1001,)], 2: [(3, 3), (37, 301)]}


def _field(shape, seed=7) -> np.ndarray:
    return jref.init_field(shape, np.float32, kind="random", seed=seed)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(UINT[a.dtype.itemsize]).astype(
        np.int64)


def _port_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).astype(np.int64)
    return _bits(t.numpy())


def _both(u_np, dtype):
    jdt, tdt = DTYPES[dtype]
    uj = jnp.asarray(u_np).astype(jdt)
    ut = from_numpy_field(u_np, "cpu", tdt)
    np.testing.assert_array_equal(_bits(np.asarray(uj)), _port_bits(ut))
    return uj, ut


def _edge(arm, dim, shape, dtype, bc) -> np.ndarray:
    """The cells JAX computes outside its kernel in the field's dtype
    (periodic sub-fp32 only; under dirichlet they are frozen)."""
    mask = np.zeros(shape, dtype=bool)
    if bc == "periodic" and dtype != "float32" and arm != "wave":
        if dim == 1:
            mask[[0, -1]] = True
        elif arm == "grid":
            mask[[0, -1], :] = True
    return mask


ARM_CASES = [
    (arm, dim, chunk, bc, dtype)
    for arm, (_, dims) in ARMS.items()
    for dim in dims
    for chunk in CHUNKS[dim]
    for bc in (("dirichlet",) if arm == "wave" else ("dirichlet", "periodic"))
    for dtype in DTYPES
]


@pytest.mark.parametrize("arm,dim,chunk,bc,dtype", ARM_CASES)
def test_arm_matches_jax_pallas_arm(arm, dim, chunk, bc, dtype):
    shape = SHAPES[dim]
    uj, ut = _both(_field(shape, seed=dim + chunk), dtype)
    jstep = getattr(JAX[dim], ARMS[arm][0])
    want = _bits(np.asarray(jstep(uj, bc=bc, rows_per_chunk=chunk,
                                  interpret=True)))
    keep = ut.clone()
    step = PORT[dim].STEPS[arm]
    before = step.launches
    got_t = step(ut, bc, rows_per_chunk=chunk)
    assert got_t.dtype == ut.dtype and torch.equal(ut, keep)
    assert step.launches == before  # the CPU runs the plain version
    got = _port_bits(got_t)
    edge = _edge(arm, dim, shape, dtype, bc)
    np.testing.assert_array_equal(got[~edge], want[~edge])
    # fields are non-negative, so the ulp distance is the bit distance
    assert np.abs(got[edge] - want[edge]).max(initial=0) <= EDGE_ULPS


@pytest.mark.parametrize("arm,dim", [(a, d) for a, (_, dims) in ARMS.items()
                                     for d in dims])
def test_arm_run_matches_jax_run_in_float32(arm, dim):
    """Four chained steps through each package's ``run``: bitwise."""
    u = _field(SHAPES[dim], seed=40 + dim)
    chunk = {"rows_per_chunk": CHUNKS[dim][0]}
    want = np.asarray(JAX[dim].run(jnp.asarray(u), 4, bc="dirichlet",
                                   impl=f"pallas-{arm}", interpret=True,
                                   **chunk))
    got = PORT[dim].run(torch.from_numpy(u), 4, bc="dirichlet", impl=arm,
                        **chunk)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("key", list(TORCH_FAMILIES))
def test_step_torch_equals_jax_step_lax_bitwise(key, bc, dtype):
    jmod, pmod, shape = TORCH_FAMILIES[key]
    uj, ut = _both(_field(shape, seed=key), dtype)
    want = _bits(np.asarray(jmod.step_lax(uj, bc=bc)))
    keep = ut.clone()
    out = torch.empty_like(ut)
    got = pmod.step_torch(ut, bc, out=out)
    assert got is out and torch.equal(ut, keep)
    np.testing.assert_array_equal(_port_bits(got), want)
    np.testing.assert_array_equal(_port_bits(pmod.step_torch(ut, bc)), want)


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("key", list(TORCH_FAMILIES))
def test_torch_arm_run_equals_jax_lax_run(key, bc):
    """Five steps through each package's ``run`` in bfloat16: bitwise."""
    jmod, pmod, shape = TORCH_FAMILIES[key]
    uj, ut = _both(_field(shape, seed=20 + key), "bfloat16")
    want = np.asarray(jmod.run(uj, 5, bc=bc, impl="lax"))
    got = pmod.run(ut, 5, bc=bc, impl="torch")
    np.testing.assert_array_equal(_port_bits(got), _bits(want))


@pytest.mark.parametrize("arm,dim", [(a, d) for a in ("grid", "wave",
                                                      "stream2", "torch")
                                     for d in (1, 2) if a in PORT[d].STEPS])
def test_ragged_shapes_equal_the_golden(arm, dim):
    """Shapes the TPU kernels refuse: float32 against the NumPy golden,
    bitwise (the golden's association, in float32)."""
    for shape in RAGGED[dim]:
        for bc in ("dirichlet",) if arm == "wave" else ("dirichlet",
                                                         "periodic"):
            u = _field(shape, seed=sum(shape))
            want = pref.jacobi_run(u, 3, bc=bc)
            got = PORT[dim].run(torch.from_numpy(u), 3, bc=bc, impl=arm)
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
            np.testing.assert_array_equal(want, jref.jacobi_run(u, 3, bc=bc))


@pytest.mark.parametrize("dim", [1, 2])
def test_wave_refuses_periodic_on_every_device(dim):
    u = torch.from_numpy(_field(SHAPES[dim]))
    with pytest.raises(ValueError, match="bc='dirichlet' only"):
        PORT[dim].step_wave(u, "periodic")
    with pytest.raises(ValueError, match="bc='dirichlet' only"):
        PORT[dim].step_wave(u.to("meta"), "periodic")
    with pytest.raises(ValueError, match="bc='dirichlet' only"):
        JAX[dim].step_pallas_wave(jnp.asarray(u.numpy()), bc="periodic",
                                  interpret=True)


@pytest.mark.parametrize("arm", ["grid", "wave", "stream2"])
def test_wrappers_never_fall_back_off_the_cpu(arm):
    """A tensor on neither the CPU nor a card is refused, not run through
    the plain version."""
    dims = ARMS[arm][1]
    for dim in dims:
        u = torch.empty(SHAPES[dim], device="meta")
        with pytest.raises(ValueError, match="CUDA tensor"):
            PORT[dim].STEPS[arm](u)


@pytest.mark.parametrize("arm", ["grid", "wave", "stream2"])
def test_wrappers_write_into_out_on_the_cpu(arm):
    for dim in ARMS[arm][1]:
        u = torch.from_numpy(_field(SHAPES[dim], seed=3))
        out = torch.empty_like(u)
        got = PORT[dim].STEPS[arm](u, "dirichlet", out=out)
        assert got is out
        assert torch.equal(out, PORT[dim].step_plain(u, "dirichlet"))


def test_default_chunks_fit_shared_memory():
    """The defaults stay within the target a CTA is sized to; a chunk
    past a CTA's shared memory is refused before a launch."""
    from tpu_comm_torch.kernels import tiling

    for dim, mod in PORT.items():
        shape = SHAPES[dim]
        for arm, smem in (("grid", tiling.grid_smem),
                          ("wave", tiling.wave_smem)):
            rows = getattr(mod, f"default_{arm}_chunk")(shape)
            assert rows % 8 == 0 and rows >= 8
            assert smem(dim, rows, 4) <= tiling.STAGED_SMEM_TARGET
            assert smem(dim, rows + 8, 4) > tiling.STAGED_SMEM_TARGET
        with pytest.raises(ValueError, match="bytes of shared memory"):
            tiling.check_staged_smem("wave", tiling.wave_smem(dim, 4096, 4),
                                     4096)
    assert p2.default_grid_chunk((65535 * 40 + 1, 8)) == 41


#: (dim, port arm, JAX arm, bc) of the driver comparisons
DRIVER_RUNS = [
    (dim, arm, jarm, bc)
    for jarm, arm in JAX_STENCIL_IMPLS.items()
    if arm in ("grid", "wave", "stream2", "torch")
    for dim in (1, 2, 3)
    if arm in kernels_for(dim).STEPS
    for bc in (("dirichlet",) if arm == "wave" else ("dirichlet", "periodic"))
]
#: (size, chunk) per dim: small for interpret mode, chunked so the JAX
#: arms cross chunk seams
DRIVER = {1: (8192, 8), 2: (128, 16), 3: (24, None)}


@pytest.mark.parametrize("dim,arm,jarm,bc", DRIVER_RUNS)
def test_driver_dump_matches_jax_driver(tmp_path, dim, arm, jarm, bc):
    size, chunk = DRIVER[dim]
    chunk = chunk if arm != "torch" else None
    load = tmp_path / "u0.npy"
    np.save(load, jref.init_field((size,) * dim, kind="random", seed=dim))
    common = dict(dim=dim, size=size, iters=4, bc=bc, chunk=chunk,
                  load=str(load))
    jstencil.run_single_device(jstencil.StencilConfig(
        impl=jarm, backend="cpu-sim", warmup=1, reps=1,
        dump=str(tmp_path / "a.npy"), **common))
    rows = tmp_path / "rows.jsonl"
    rec = pstencil.run_single_device(pstencil.StencilConfig(
        impl=arm, backend="cpu", warmup=1, reps=7, verify=True,
        verify_iters=4, dump=str(tmp_path / "b.npy"), jsonl=str(rows),
        **common))
    a, b = np.load(tmp_path / "a.npy"), np.load(tmp_path / "b.npy")
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(b, a)
    # every arm is the same function: the stream arm's dump too
    pstencil.run_single_device(pstencil.StencilConfig(
        impl="stream", backend="cpu", warmup=1, reps=1,
        dump=str(tmp_path / "c.npy"), **{**common, "chunk": None}))
    np.testing.assert_array_equal(np.load(tmp_path / "c.npy"), b)
    assert (rec["impl"], rec["platform"], rec["verified"]) == (
        arm, "cpu", True)
    assert rec["workload"] == f"stencil{dim}d"
    if arm == "torch":
        assert "chunk" not in rec
    else:
        assert (rec["chunk"], rec["chunk_source"]) == (chunk, "user")
    errors, warnings = validate_row(json.loads(rows.read_text()))
    assert errors == [] and warnings == []


@pytest.mark.parametrize("arm,dim", [("grid", 1), ("grid", 2), ("wave", 1),
                                     ("wave", 2), ("stream2", 1),
                                     ("torch", 1), ("torch", 2)])
def test_cli_runs_each_arm_on_cpu(tmp_path, capsys, arm, dim):
    path = tmp_path / "rows.jsonl"
    with fake_clock():  # the row's timing, on the test's clock
        rc = cli.main(["stencil", "--backend", "cpu", "--dim", str(dim),
                       "--size", "256", "--iters", "4", "--impl", arm,
                       "--verify", "--verify-iters", "6", "--jsonl",
                       str(path)])
    assert rc == 0
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(rows) == 1
    row = rows[0]
    assert (row["impl"], row["platform"], row["verified"]) == (
        arm, "cpu", True)
    if arm == "torch":
        assert "chunk" not in row
    else:
        want = getattr(PORT[dim], {"stream2": "default_chunk"}.get(
            arm, f"default_{arm}_chunk"))((256,) * dim)
        assert (row["chunk"], row["chunk_source"]) == (want, "auto")
    printed = json.loads(capsys.readouterr().out)
    assert (printed["impl"], printed["secs_per_iter"]) == (
        arm, row["secs_per_iter"]) == (arm, PER_ITER_S)


def test_cli_module_entry_runs_the_wave_arm(tmp_path):
    path = tmp_path / "rows.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "tpu_comm_torch", "stencil", "--backend",
         "cpu", "--dim", "2", "--size", "256", "--impl", "wave",
         "--iters", "4", "--verify", "--jsonl", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    row = json.loads(path.read_text())
    assert (row["impl"], row["verified"], row["size"]) == (
        "wave", True, [256, 256])


def test_torch_arm_runs_the_tol_mode(tmp_path):
    """The convergence loop stops where the golden's does."""
    rec = pstencil.run_single_device(pstencil.StencilConfig(
        dim=2, size=64, iters=200, tol=0.4, check_every=5, impl="torch",
        backend="cpu", verify=True, warmup=1, reps=1))
    _, want_iters, _ = jref.jacobi_run_to_convergence(
        jref.init_field((64, 64)), 0.4, 200, check_every=5)
    assert rec["iters"] == want_iters and rec["converged"]
    assert rec["workload"] == "stencil2d-conv" and rec["impl"] == "torch"


@pytest.mark.parametrize("argv,message", [
    (["--dim", "1", "--impl", "wave", "--bc", "periodic"],
     "wave supports bc='dirichlet' only, as JAX's pallas-wave"),
    (["--dim", "2", "--impl", "wave", "--bc", "periodic"],
     "use stream for periodic"),
    (["--dim", "1", "--impl", "pallas-grid"],
     "--impl pallas-grid is the JAX package's name; the port calls this "
     "arm 'grid'"),
    (["--dim", "1", "--impl", "pallas-stream2"],
     "the port calls this arm 'stream2'"),
    (["--dim", "3", "--impl", "wave"],
     "--impl wave not available for dim=3"),
    (["--dim", "3", "--impl", "grid"],
     "--impl grid not available for dim=3"),
    (["--dim", "2", "--impl", "stream2"],
     "--impl stream2 not available for dim=2"),
    (["--points", "9", "--dim", "2", "--impl", "wave", "--bc", "periodic"],
     "wave supports bc='dirichlet' only, as JAX's pallas-wave"),
    (["--points", "27", "--dim", "3", "--impl", "wave", "--bc",
      "periodic"], "wave supports bc='dirichlet' only"),
    (["--points", "9", "--dim", "2", "--impl", "grid"],
     "--impl grid not available for --points 9"),
    (["--dim", "2", "--mesh", "2,2", "--impl", "wave", "--pack", "kernel"],
     "pack='kernel' needs a 3D mesh and impl=overlap|block|stream"),
    (["--dim", "2", "--mesh", "2,2", "--impl", "grid"],
     "--impl grid is an arm of one device: drop --mesh"),
    (["--dim", "1", "--mesh", "2", "--impl", "stream2"],
     "--impl stream2 is an arm of one device: drop --mesh"),
    (["--dim", "1", "--impl", "torch", "--chunk", "8"],
     "--chunk applies to --impl stream|stream2|grid|wave|multi"),
])
def test_cli_refuses_what_the_arms_do_not_run(capsys, argv, message):
    rc = cli.main(["stencil", "--backend", "cpu", "--size", "16", "--iters",
                   "2", *argv])
    assert rc == 2
    assert message in capsys.readouterr().err


def test_cli_runs_the_wave_arm_on_a_mesh(tmp_path, capsys):
    """``--mesh 2,2 --impl wave``, once refused with the cases above, runs
    on 4 ranks, verifies, and its one row names the arm."""
    path = tmp_path / "rows.jsonl"
    rc = cli.main(["stencil", "--backend", "cpu", "--size", "16", "--iters",
                   "2", "--dim", "2", "--mesh", "2,2", "--impl", "wave",
                   "--verify", "--jsonl", str(path)])
    assert rc == 0
    row = json.loads(path.read_text())
    assert (row["workload"], row["impl"], row["mesh"], row["verified"]) == (
        "stencil2d-dist", "wave", [2, 2], True)
    capsys.readouterr()


def test_jax_refuses_the_same_arms():
    """The JAX package has no 3D grid or wave arm and no 2D stream2, and
    its distributed step knows neither grid nor stream2."""
    for dim, jarm in ((3, "pallas-wave"), (3, "pallas-grid"),
                      (2, "pallas-stream2")):
        with pytest.raises(ValueError, match=f"not available for dim={dim}"):
            jstencil.run_single_device(jstencil.StencilConfig(
                dim=dim, size=16, iters=2, impl=jarm, backend="cpu-sim"))
