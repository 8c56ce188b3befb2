"""The rest of the Trap-1 family held against the JAX package, on the
CPU: the 9-point and 27-point ``wave`` arms against ``pallas-wave`` and
the 3D ``multi`` arm (the wavefront) against ``pallas-multi`` (Pallas in
interpret mode, as the JAX package's own tests run them; the port's
wrappers run their plain versions on a CPU tensor), then against the
NumPy golden, ragged shapes, the driver, its rows, the CLI and the
refusals; and the ghost-fed wave steps of the mesh ``wave`` arm
(``jacobi1d``/``jacobi2d.step_wave_ghost``) against JAX's
``step_pallas_wave_ghost``.

Inputs are seeded NumPy fields, the same values to both packages.
Tolerances:
- the box waves: bitwise in float32, bfloat16 and float16 (JAX computes
  every cell in its kernel in float32 in the golden's association and
  narrows once, as the port does).
- the 3D multi against JAX: bitwise at t = 1; at t >= 2 within JAX's own
  contract, t * 2^-23 * max|u0| (``tests/test_multistep.py``): XLA:CPU may
  contract a level's ``* 1/6`` into the next level's add, which the port
  never does.
- the 3D multi against the golden: bitwise in float32 (t float32 steps in
  the golden's association, ``-fmad=false`` on the card). In bfloat16 and
  float16 the port's t steps are the golden's float32 steps on the widened
  field, rounded once: the result is exactly the golden rounded to nearest
  even, so within half an ulp, at most 2^-8 (bfloat16) or 2^-11 (float16)
  of max|golden|. For t >= 2 that is no looser than JAX's own bfloat16
  envelope, 2^-9 * iters * scale (``tests/test_multistep.py``).
- the 1D ghost-fed step against JAX's ``step_pallas_wave_ghost``:
  bitwise in every dtype (both compute in float32 from the ghost cells
  and narrow once).
- the 2D ghost-fed step against JAX's local update, its kernel
  (``step_pallas_wave_ghost``) and its seam-column recompute: bitwise in
  float32 (the same association, ``((up + down) + (left + right)) *
  0.25``). In bfloat16 and float16 bitwise off the two seam columns; on
  them JAX adds in the field's dtype (two levels of rounded adds, each
  level off by at most half an ulp of each partial sum, together at most
  1 ulp of the total per level for non-negative values, then an exact
  multiply by 1/4) against the port's one rounding of the float32 sum:
  at most 2 ulps of the result.
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
from tpu_comm.kernels import jacobi3d as j3
from tpu_comm.kernels import reference as jref
from tpu_comm.kernels import stencil9 as j9
from tpu_comm.kernels import stencil27 as j27
from tpu_comm_torch import cli
from tpu_comm_torch.bench import stencil as pstencil
from tpu_comm_torch.kernels import jacobi1d as p1
from tpu_comm_torch.kernels import jacobi2d as p2
from tpu_comm_torch.kernels import jacobi3d as p3
from tpu_comm_torch.kernels import kernels_for
from tpu_comm_torch.kernels import reference as pref
from tpu_comm_torch.kernels import stencil9 as p9
from tpu_comm_torch.kernels import stencil27 as p27
from tpu_comm_torch.kernels import tiling
from tpu_comm_torch.kernels.tiling import from_numpy_field
from torch_fake_clock import PER_ITER_S, fake_clock

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
    "float16": (jnp.float16, torch.float16),
}
UINT = {4: np.uint32, 2: np.uint16}
#: the box waves: --points -> (JAX module, port module, a shape the TPU
#: kernel takes)
BOX = {9: (j9, p9, (64, 256)), 27: (j27, p27, (10, 16, 128))}
#: the 3D multi's shape the TPU kernel takes
SHAPE3 = (10, 16, 128)
#: shapes the TPU kernels refuse (ny not a multiple of 8, nx not one of
#: 128); the port takes them
RAGGED = {9: [(3, 3), (37, 45)], 27: [(3, 3, 3), (7, 9, 11)],
          3: [(3, 3, 3), (7, 9, 11), (2, 5, 7)]}


def _field(shape, seed=7) -> np.ndarray:
    return jref.init_field(shape, np.float32, kind="random", seed=seed)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(UINT[a.dtype.itemsize]).astype(
        np.int64)


def _port_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).astype(np.int64)
    return _bits(t.numpy())


def _ulp(a: np.ndarray, dtype: str) -> np.ndarray:
    """The ulp of each value of ``a`` in ``dtype`` (normal range)."""
    bits = {"bfloat16": 7, "float16": 10}[dtype]
    return 2.0 ** (np.floor(np.log2(np.abs(a))) - bits)


def _both(u_np, dtype):
    jdt, tdt = DTYPES[dtype]
    uj = jnp.asarray(u_np).astype(jdt)
    ut = from_numpy_field(u_np, "cpu", tdt)
    np.testing.assert_array_equal(_bits(np.asarray(uj)), _port_bits(ut))
    return uj, ut


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_stencil9_wave_equals_jax_pallas_wave(chunk, dtype):
    uj, ut = _both(_field(BOX[9][2], seed=chunk), dtype)
    want = _bits(np.asarray(j9.step_pallas_wave(
        uj, bc="dirichlet", rows_per_chunk=chunk, interpret=True)))
    keep = ut.clone()
    before = p9.step_wave.launches
    got = p9.step_wave(ut, "dirichlet", rows_per_chunk=chunk)
    assert got.dtype == ut.dtype and torch.equal(ut, keep)
    assert p9.step_wave.launches == before  # the CPU runs the plain version
    np.testing.assert_array_equal(_port_bits(got), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stencil27_wave_equals_jax_pallas_wave(dtype):
    uj, ut = _both(_field(BOX[27][2], seed=27), dtype)
    want = _bits(np.asarray(j27.step_pallas_wave(uj, bc="dirichlet",
                                                 interpret=True)))
    keep = ut.clone()
    before = p27.step_wave.launches
    got = p27.step_wave(ut, "dirichlet")
    assert got.dtype == ut.dtype and torch.equal(ut, keep)
    assert p27.step_wave.launches == before
    np.testing.assert_array_equal(_port_bits(got), want)


@pytest.mark.parametrize("points", [9, 27])
def test_box_wave_run_equals_jax_run(points):
    """Four chained steps through each package's ``run`` in float32:
    bitwise."""
    jmod, pmod, shape = BOX[points]
    u = _field(shape, seed=40 + points)
    chunk = {"rows_per_chunk": 16} if points == 9 else {}
    want = np.asarray(jmod.run(jnp.asarray(u), 4, bc="dirichlet",
                               impl="pallas-wave", interpret=True, **chunk))
    got = pmod.run(torch.from_numpy(u), 4, bc="dirichlet", impl="wave",
                   **chunk)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_stencil27_wave_at_two_planes_is_the_identity():
    """nz = 2: both planes are frozen z faces, in both packages."""
    u = _field((2, 16, 128), seed=2)
    want = np.asarray(j27.step_pallas_wave(jnp.asarray(u), interpret=True))
    got = p27.step_wave(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(got, u)


@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_multi3d_equals_jax_pallas_multi(t):
    u = _field(SHAPE3, seed=t)
    want = np.asarray(j3.step_pallas_multi(jnp.asarray(u), t_steps=t,
                                           interpret=True))
    ut = torch.from_numpy(u)
    keep = ut.clone()
    before = p3.step_multi.launches
    got = p3.step_multi(ut, "dirichlet", t).numpy()
    assert torch.equal(ut, keep) and p3.step_multi.launches == before
    if t == 1:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        scale = float(np.abs(u).max())
        assert np.abs(got - want).max() <= t * 2.0 ** -23 * scale
    # the port is the golden's t serial steps, bitwise
    np.testing.assert_array_equal(_bits(got), _bits(jref.jacobi_run(u, t)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_multi3d_equals_jax_at_one_step_in_every_dtype(dtype):
    """One level has no contraction site: bitwise in the narrow dtypes
    too."""
    uj, ut = _both(_field(SHAPE3, seed=11), dtype)
    want = _bits(np.asarray(j3.step_pallas_multi(uj, t_steps=1,
                                                 interpret=True)))
    np.testing.assert_array_equal(_port_bits(p3.step_multi(ut, t_steps=1)),
                                  want)


@pytest.mark.parametrize("t", [1, 3, 4, 9])
def test_multi3d_equals_the_golden_in_float32(t):
    """t serial golden steps, bitwise, past one launch's most steps
    (``tiling.MULTI_T_MAX[3]``) too."""
    u = _field(SHAPE3, seed=20 + t)
    got = p3.step_multi(torch.from_numpy(u), "dirichlet", t).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(pref.jacobi_run(u, t)))


@pytest.mark.parametrize("t", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_multi3d_sub_fp32_is_the_golden_rounded_once(dtype, t):
    """The module docstring's bound: the golden rounded to nearest even,
    within half an ulp, no looser than JAX's bfloat16 envelope."""
    _, tdt = DTYPES[dtype]
    ut = from_numpy_field(_field(SHAPE3, seed=30 + t), "cpu", tdt)
    want = pref.jacobi_run(ut.float().numpy(), t)
    got = p3.step_multi(ut, "dirichlet", t)
    assert torch.equal(got, torch.from_numpy(want).to(tdt))
    unit = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}[dtype]
    scale = float(np.abs(want).max())
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= unit * scale <= 2.0 ** -9 * t * max(scale, 1.0)


def test_run_multi3d_equals_jax_run_multi():
    """Two chained passes of t = 4 through each package's ``run_multi``:
    within JAX's envelope, and the port bitwise to the golden."""
    u = _field(SHAPE3, seed=50)
    want = np.asarray(j3.run_multi(jnp.asarray(u), 8, bc="dirichlet",
                                   t_steps=4, interpret=True))
    got = p3.run_multi(torch.from_numpy(u), 8, bc="dirichlet",
                       t_steps=4).numpy()
    assert np.abs(got - want).max() <= 8 * 2.0 ** -23 * float(
        np.abs(u).max())
    np.testing.assert_array_equal(_bits(got), _bits(jref.jacobi_run(u, 8)))


def test_multi3d_at_two_planes_is_the_identity():
    u = _field((2, 8, 128), seed=3)
    want = np.asarray(j3.step_pallas_multi(jnp.asarray(u), t_steps=4,
                                           interpret=True))
    got = p3.step_multi(torch.from_numpy(u), t_steps=4).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, u)


@pytest.mark.parametrize("key", [9, 27, 3])
def test_ragged_shapes_equal_the_golden(key):
    """Shapes the TPU kernels refuse: float32 against the NumPy golden,
    bitwise."""
    for shape in RAGGED[key]:
        u = _field(shape, seed=sum(shape))
        ut = torch.from_numpy(u)
        if key == 3:
            got = p3.run_multi(ut, 6, t_steps=3)
            want = pref.jacobi_run(u, 6)
        else:
            got = BOX[key][1].run(ut, 3, impl="wave")
            want = pref.GOLDEN_RUNS[key](u, 3)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_defaults_fit_their_blocks():
    """The 27-point wave's default tile fits the shared memory a CTA is
    sized to; the wavefront's default tile and apron fit a block at every
    t a launch runs; what does not fit is refused before a launch."""
    rows = p27.default_wave_chunk((512,) * 3)
    assert tiling.wave_smem(3, rows, 4) <= tiling.STAGED_SMEM_TARGET
    assert rows % 8 == 0
    assert tiling.wave_smem(3, rows + 8, 4) > tiling.STAGED_SMEM_TARGET
    assert p9.default_wave_chunk((64, 256)) == (
        kernels_for(2).default_wave_chunk((64, 256)))
    with pytest.raises(ValueError, match="bytes of shared memory"):
        tiling.check_staged_smem("wave", tiling.wave_smem(3, 4096, 4), 4096)
    assert tiling.wave_smem(3, tiling.WAVE3D_MAX_ROWS, 4) <= (
        tiling.STAGED_MAX_SMEM)
    tile = p3.MULTI_DEFAULT_TILE
    assert p3.default_multi_chunk((512,) * 3) == tile[0]
    for t in range(1, tiling.MULTI_T_MAX[3] + 1):
        tiling.check_multi_tile(3, tile, t)
    with pytest.raises(ValueError, match="threads"):
        tiling.check_multi_tile(3, (1000, 24), 4)


@pytest.mark.parametrize("tile,extents", [
    ((56, 56), (512, 512)), ((1000, 24), (4096, 4096)),
    ((1, 1000), (8, 1024)), ((8, 24), (3, 5)), ((5, 19), (512, 512)),
    ((4096, 4096), (4096, 4096)), ((1, 1), (3, 3)),
])
@pytest.mark.parametrize("t", [1, 2, 3, 4])
def test_wavefront_block_tile_fits_and_cuts_only_what_it_must(tile, extents,
                                                              t):
    """``multi3d_block_tile`` takes every tile: cut to the field, then
    halved on its longer side until the window fits a block's threads;
    a tile that fits (cut to the field) is taken as it is."""
    got = tiling.multi3d_block_tile(tile, t, extents)
    cut = (min(tile[0], extents[0]), min(tile[1], extents[1]))
    tiling.check_multi_tile(3, got, t)
    assert tiling.multi_smem(3, got, t) <= tiling.MAX_SMEM_BYTES
    assert 1 <= got[0] <= cut[0] and 1 <= got[1] <= cut[1]
    if tiling.multi3d_threads(cut, t) <= tiling.MULTI3D_MAX_THREADS:
        assert got == cut
    with pytest.raises(ValueError, match="tile must be >= 1"):
        tiling.multi3d_block_tile((0, 4), t, extents)
    default = tiling.multi3d_default_tile(t)
    tiling.check_multi_tile(3, default, t)
    assert default[1] + 2 * t == tiling.MULTI3D_WINDOW[1]


@pytest.mark.parametrize("mod", [p9.step_wave, p27.step_wave,
                                 p3.step_multi])
def test_wrappers_refuse_periodic_and_never_fall_back(mod):
    shape = {p9.step_wave: (8, 8), p27.step_wave: (4, 8, 8),
             p3.step_multi: (4, 8, 8)}[mod]
    u = torch.from_numpy(_field(shape))
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="bc='dirichlet' only"):
            mod(u.to(dev), "periodic")
    with pytest.raises(ValueError, match="CUDA tensor"):
        mod(u.to("meta"))
    out = torch.empty_like(u)
    assert mod(u, out=out) is out


def test_jax_refuses_periodic_too():
    u3 = jnp.asarray(_field(SHAPE3))
    with pytest.raises(ValueError, match="dirichlet"):
        j27.step_pallas_wave(u3, bc="periodic", interpret=True)
    with pytest.raises(ValueError, match="dirichlet"):
        j3.step_pallas_multi(u3, bc="periodic", interpret=True)
    with pytest.raises(ValueError, match="dirichlet"):
        j9.step_pallas_wave(jnp.asarray(_field((64, 256))), bc="periodic",
                            interpret=True)


#: (dim, --points, port arm, JAX arm, extra config) of the driver runs
DRIVER_RUNS = [
    (2, 9, "wave", "pallas-wave", {"chunk": 16, "iters": 4}),
    (3, 27, "wave", "pallas-wave", {"iters": 4}),
    (3, 0, "multi", "pallas-multi", {"iters": 8, "t_steps": 4}),
]


@pytest.mark.parametrize("dim,points,arm,jarm,extra", DRIVER_RUNS)
def test_driver_dump_matches_jax_driver(tmp_path, dim, points, arm, jarm,
                                        extra):
    load = tmp_path / "u0.npy"
    u0 = _field((128,) * dim, seed=60 + dim)
    np.save(load, u0)
    common = dict(dim=dim, points=points, size=128, load=str(load), **extra)
    jstencil.run_single_device(jstencil.StencilConfig(
        impl=jarm, backend="cpu-sim", warmup=1, reps=1,
        dump=str(tmp_path / "a.npy"), **common))
    rows = tmp_path / "rows.jsonl"
    rec = pstencil.run_single_device(pstencil.StencilConfig(
        impl=arm, backend="cpu", warmup=1, reps=3, verify=True,
        verify_iters=4, dump=str(tmp_path / "b.npy"), jsonl=str(rows),
        **common))
    a, b = np.load(tmp_path / "a.npy"), np.load(tmp_path / "b.npy")
    if arm == "wave":
        np.testing.assert_array_equal(_bits(b), _bits(a))
    else:
        iters = extra["iters"]
        assert np.abs(b - a).max() <= iters * 2.0 ** -23 * float(
            np.abs(u0).max())
        np.testing.assert_array_equal(_bits(b),
                                      _bits(jref.jacobi_run(u0, iters)))
    tag = {0: "stencil3d", 9: "stencil2d-9pt", 27: "stencil3d-27pt"}[points]
    assert (rec["workload"], rec["impl"], rec["platform"],
            rec["verified"]) == (tag, arm, "cpu", True)
    if dim == 3:
        assert "chunk" not in rec  # as the JAX driver's 3D wave and multi
    else:
        assert (rec["chunk"], rec["chunk_source"]) == (16, "user")
    if arm == "multi":
        assert rec["t_steps"] == 4
    errors, warnings = validate_row(json.loads(rows.read_text()))
    assert errors == [] and warnings == []


@pytest.mark.parametrize("argv,impl", [
    (["--points", "9", "--dim", "2", "--size", "64", "--iters", "4"],
     "wave"),
    (["--points", "27", "--dim", "3", "--size", "24", "--iters", "4"],
     "wave"),
    (["--dim", "3", "--size", "24", "--iters", "8", "--t-steps", "4"],
     "multi"),
])
def test_cli_runs_each_arm_on_cpu(tmp_path, capsys, argv, impl):
    path = tmp_path / "rows.jsonl"
    with fake_clock():  # the row's timing, on the test's clock
        rc = cli.main(["stencil", "--backend", "cpu", *argv, "--impl",
                       impl, "--verify", "--jsonl", str(path)])
    assert rc == 0
    lines = path.read_text().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert (row["impl"], row["platform"], row["verified"]) == (
        impl, "cpu", True)
    printed = json.loads(capsys.readouterr().out)
    assert printed["secs_per_iter"] == row["secs_per_iter"] == PER_ITER_S


def test_cli_module_entry_runs_the_3d_multi_arm(tmp_path):
    path = tmp_path / "rows.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "tpu_comm_torch", "stencil", "--backend",
         "cpu", "--dim", "3", "--size", "24", "--iters", "8", "--impl",
         "multi", "--t-steps", "4", "--verify", "--jsonl", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    row = json.loads(path.read_text())
    assert (row["workload"], row["impl"], row["t_steps"], row["verified"],
            row["size"]) == ("stencil3d", "multi", 4, True, [24, 24, 24])


@pytest.mark.parametrize("argv,message", [
    (["--points", "9", "--dim", "2", "--impl", "wave", "--bc", "periodic"],
     "wave supports bc='dirichlet' only, as JAX's pallas-wave"),
    (["--points", "27", "--dim", "3", "--impl", "wave", "--bc",
      "periodic"], "use stream for periodic"),
    (["--dim", "3", "--impl", "multi", "--bc", "periodic", "--iters", "8"],
     "--impl multi in 3D (wavefront temporal blocking) supports --bc "
     "dirichlet only; use stream for periodic"),
    (["--dim", "3", "--impl", "multi", "--chunk", "4", "--iters", "8"],
     "--chunk does not apply to 3D multi: the wavefront/wave kernels "
     "stream one plane per grid step"),
    (["--points", "27", "--dim", "3", "--impl", "wave", "--chunk", "4"],
     "--chunk does not apply to 3D wave"),
    (["--points", "27", "--dim", "3", "--impl", "multi", "--iters", "8"],
     "--impl multi is not available for --points 27"),
])
def test_cli_refuses_what_jax_refuses(capsys, argv, message):
    rc = cli.main(["stencil", "--backend", "cpu", "--size", "16", *argv])
    assert rc == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("cfg,message", [
    (dict(dim=3, impl="pallas-multi", bc="periodic", iters=8),
     "pallas-multi in 3D (wavefront temporal blocking) supports --bc "
     "dirichlet only; use pallas-stream for periodic"),
    (dict(dim=3, impl="pallas-multi", chunk=4, iters=8),
     "--chunk does not apply to 3D pallas-multi: the wavefront/wave "
     "kernels stream one plane per grid step"),
    (dict(dim=3, points=27, impl="pallas-wave", chunk=4, iters=4),
     "--chunk does not apply to 3D pallas-wave"),
    (dict(dim=3, points=27, impl="pallas-multi", iters=8),
     "--impl pallas-multi is not available for --points 27"),
])
def test_jax_driver_refuses_the_same(cfg, message):
    """The refusals above are the JAX driver's, in its arm names."""
    with pytest.raises(ValueError) as err:
        jstencil.run_single_device(jstencil.StencilConfig(
            size=128, backend="cpu-sim", **cfg))
    assert message in str(err.value)


#: the ghost-fed steps: shapes the TPU kernels take, and ragged ones
GHOST_SHAPES = {1: (2048,), 2: (32, 256)}
GHOST_RAGGED = {1: [(1,), (2,), (3,), (1001,)],
                2: [(1, 1), (3, 3), (37, 45), (5, 257), (2, 1)]}


def _ghosts(shape, dtype, seed):
    """Random nonzero ghost lines of a block of ``shape``, both packages'
    (1D: lo, hi; 2D: up, down, left, right)."""
    rng = np.random.default_rng(seed)
    if len(shape) == 1:
        shapes = [(1,), (1,)]
    else:
        ny, nx = shape
        shapes = [(1, nx), (1, nx), (ny, 1), (ny, 1)]
    return [_both((rng.random(s) + 0.5).astype(np.float32), dtype)
            for s in shapes]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk", [8, 16])
def test_wave_ghost_1d_equals_jax_pallas_wave_ghost(chunk, dtype):
    uj, ut = _both(_field(GHOST_SHAPES[1], seed=chunk), dtype)
    (loj, lot), (hij, hit) = _ghosts(GHOST_SHAPES[1], dtype, chunk)
    from tpu_comm.kernels import jacobi1d as j1

    want = _bits(np.asarray(j1.step_pallas_wave_ghost(
        uj, loj, hij, rows_per_chunk=chunk, interpret=True)))
    keep = ut.clone()
    before = p1.step_wave_ghost.launches
    got = p1.step_wave_ghost(ut, lot, hit, rows_per_chunk=chunk)
    assert got.dtype == ut.dtype and torch.equal(ut, keep)
    assert p1.step_wave_ghost.launches == before  # the plain version ran
    np.testing.assert_array_equal(_port_bits(got), want)
    np.testing.assert_array_equal(
        _port_bits(p1.step_wave_ghost_plain(ut, lot, hit)), want)


def _jax_wave_ghost_2d(uj, upj, dnj, lej, rij, chunk):
    """JAX's 2D mesh ``pallas-wave`` update without its freeze: the
    ghost-fed kernel, then the two seam columns recomputed in the field's
    dtype (``tpu_comm/kernels/distributed.py`` ``make_local_step``)."""
    from tpu_comm.kernels import jacobi2d as j2

    new = j2.step_pallas_wave_ghost(uj, upj, dnj, rows_per_chunk=chunk,
                                    interpret=True)
    nx = uj.shape[1]
    quarter = jnp.asarray(0.25, dtype=uj.dtype)

    def vcol(c):
        up_c = jnp.concatenate([upj[:, c:c + 1], uj[:-1, c:c + 1]], axis=0)
        dn_c = jnp.concatenate([uj[1:, c:c + 1], dnj[:, c:c + 1]], axis=0)
        return up_c + dn_c

    col0 = (vcol(0) + (lej + uj[:, 1:2])) * quarter
    coln = (vcol(nx - 1) + (uj[:, nx - 2:nx - 1] + rij)) * quarter
    return jnp.concatenate([col0, new[:, 1:-1], coln], axis=1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk", [8, 16])
def test_wave_ghost_2d_equals_jax_local_update(chunk, dtype):
    """The module docstring's bound: bitwise in float32, and off the seam
    columns in every dtype; within 2 ulps on them."""
    uj, ut = _both(_field(GHOST_SHAPES[2], seed=chunk), dtype)
    ghosts = _ghosts(GHOST_SHAPES[2], dtype, chunk)
    want = np.asarray(_jax_wave_ghost_2d(
        uj, *(g for g, _ in ghosts), chunk).astype(jnp.float32))
    keep = ut.clone()
    before = p2.step_wave_ghost.launches
    got = p2.step_wave_ghost(ut, *(g for _, g in ghosts),
                             rows_per_chunk=chunk)
    assert got.dtype == ut.dtype and torch.equal(ut, keep)
    assert p2.step_wave_ghost.launches == before
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(_bits(got), _bits(want))
        return
    np.testing.assert_array_equal(got[:, 1:-1], want[:, 1:-1])
    seams = np.stack([got[:, [0, -1]], want[:, [0, -1]]])
    err = np.abs(seams[0] - seams[1])
    assert (err <= 2 * _ulp(seams.max(axis=0), dtype)).all()


@pytest.mark.parametrize("dim", [1, 2])
def test_wave_ghost_of_the_own_edges_is_the_periodic_step(dim):
    """A block whose ghosts are its own opposite edges (a periodic mesh of
    one rank) steps as the golden's periodic step, bitwise in float32, at
    the TPU kernels' shapes and at ragged ones."""
    for shape in [GHOST_SHAPES[dim]] + GHOST_RAGGED[dim]:
        u = _field(shape, seed=sum(shape))
        ut = torch.from_numpy(u)
        if dim == 1:
            got = p1.step_wave_ghost(ut, ut[-1:], ut[:1])
        else:
            got = p2.step_wave_ghost(ut, ut[-1:], ut[:1], ut[:, -1:],
                                     ut[:, :1])
        want = pref.GOLDEN_RUNS[0](u, 1, bc="periodic")
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("dim", [1, 2])
def test_wave_ghost_refuses_bad_ghosts_and_never_falls_back(dim):
    mod = {1: p1, 2: p2}[dim]
    shape = GHOST_SHAPES[dim]
    u = torch.from_numpy(_field(shape))
    ghosts = [g for _, g in _ghosts(shape, "float32", 3)]
    bad = [torch.zeros(2) if dim == 1 else torch.zeros(2, shape[1])]
    with pytest.raises(ValueError, match="ghost (cells|lines)"):
        mod.step_wave_ghost(u, *(bad + ghosts[1:]))
    with pytest.raises(ValueError, match="dtype and device"):
        mod.step_wave_ghost(u, *([ghosts[0].double()] + ghosts[1:]))
    with pytest.raises(ValueError, match="must not alias"):
        mod.step_wave_ghost(u, *ghosts, out=u)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mod.step_wave_ghost(u.to("meta"), *(g.to("meta") for g in ghosts))
    out = torch.empty_like(u)
    assert mod.step_wave_ghost(u, *ghosts, out=out) is out
