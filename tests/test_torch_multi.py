"""The port's temporal blocking (``--impl multi`` on one device) held
against the JAX package's ``pallas-multi``, on the CPU: the kernels'
plain versions against ``step_pallas_multi`` (interpret mode, as the JAX
package's own tests run it) and ``run_multi``, the plain versions against
t serial golden steps, the driver, its rows, its refusals and its CLI.

Inputs are seeded NumPy fields. Tolerances:
- float32: bitwise everywhere. Both packages take t steps in float32 in
  the golden's association; JAX's edge fixes run in the field's dtype,
  which is float32 here.
- bfloat16: bitwise outside the edge bands that JAX recomputes outside
  its kernel in the field's dtype (ROADMAP "Trap 4, multi"): in 1D the
  first and last t cells under both bcs, in 2D and 9-point the top and
  bottom t rows under periodic only (dirichlet freezes its ring in the
  kernel: no band). Inside a band JAX takes t steps each rounded to
  bfloat16, the port t float32 steps rounded once. The fields are
  non-negative and a step is a mean, so no value exceeds M = max|u|. A
  step's rounded adds are off by at most u = 2^-8 (bfloat16's unit
  roundoff) of their partial sums, L levels of them (1 in 1D, 2 for the
  star, 3 for the box; the multiply by 1/2, 1/4 or 1/8 is exact), at
  most L*u*M a step; a mean carries earlier errors on without growing
  them, so after t steps JAX is within t*L*u*M of the exact value. The
  port's float32 error is below 2^-24*t*L*M and its one rounding below
  u*M. u*M is less than one bfloat16 ulp of M, so the two differ by at
  most t*L + 2 ulps of M (the last ulp covering the float32 part).
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
from tpu_comm.kernels import reference as jref
from tpu_comm.kernels import stencil9 as j9
from tpu_comm_torch import cli
from tpu_comm_torch.bench import stencil as pstencil
from tpu_comm_torch.kernels import jacobi1d as p1
from tpu_comm_torch.kernels import jacobi2d as p2
from tpu_comm_torch.kernels import kernels_for, run_steps, run_steps_multi
from tpu_comm_torch.kernels import reference as pref
from tpu_comm_torch.kernels import stencil9 as p9

ROOT = Path(__file__).resolve().parents[1]
#: family (the driver's --points, or the star's dim) -> (JAX module, port
#: module, a shape the TPU kernel takes, the JAX chunk that crosses strip
#: seams, add levels a step: L of the module docstring)
FAMILIES = {
    1: (j1, p1, (8192,), {"rows_per_chunk": 8}, 1),
    2: (j2, p2, (64, 256), {"rows_per_chunk": 16}, 2),
    9: (j9, p9, (64, 256), {"rows_per_chunk": 16}, 3),
}
#: shapes the TPU kernels refuse (not tile-aligned); the port takes them
RAGGED = {1: [(3,), (1001,)], 2: [(3, 3), (37, 301)],
          9: [(3, 3), (30, 50)]}
BF16_ULP_EXP = 7  # a bfloat16 value in [2^e, 2^(e+1)) has ulp 2^(e-7)


def _field(shape, seed=7) -> np.ndarray:
    return jref.init_field(shape, np.float32, kind="random", seed=seed)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint32).astype(np.int64)


def _jax_multi(key, u0, bc, t, dtype):
    jmod, _, _, chunk, _ = FAMILIES[key]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out = jmod.step_pallas_multi(jnp.asarray(u0).astype(jdt), bc=bc,
                                 t_steps=t, interpret=True, **chunk)
    return np.asarray(out.astype(jnp.float32))


def _port_multi(key, u0, bc, t, dtype):
    _, pmod, _, _, _ = FAMILIES[key]
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    u = torch.from_numpy(u0).to(tdt)
    keep = u.clone()
    out = pmod.step_multi(u, bc, t)
    assert out.dtype == tdt and torch.equal(u, keep)  # u is only read
    return out.float().numpy()


def _band(key, shape, bc, t) -> np.ndarray:
    """Cells JAX recomputes outside its kernel in the field's dtype."""
    band = np.zeros(shape, dtype=bool)
    if key == 1:
        band[:t] = band[-t:] = True
    elif bc == "periodic":
        band[:t] = band[-t:] = True
    return band


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("t", [1, 2, 8])
@pytest.mark.parametrize("key", list(FAMILIES))
def test_step_multi_equals_jax_step_pallas_multi(key, t, bc, dtype):
    shape = FAMILIES[key][2]
    u0 = _field(shape, seed=key + t)
    if dtype == "bfloat16":  # both start from the same bfloat16 field
        u0 = torch.from_numpy(u0).bfloat16().float().numpy()
    want = _jax_multi(key, u0, bc, t, dtype)
    got = _port_multi(key, u0, bc, t, dtype)
    if dtype == "float32":
        np.testing.assert_array_equal(_bits(got), _bits(want))
        return
    band = _band(key, shape, bc, t)
    np.testing.assert_array_equal(got[~band], want[~band])
    levels = FAMILIES[key][4]
    m = float(np.abs(u0).max())
    ulp = 2.0 ** (np.floor(np.log2(m)) - BF16_ULP_EXP)
    bound = (t * levels + 2) * ulp
    err = float(np.abs(got[band] - want[band]).max(initial=0.0))
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("key", list(FAMILIES))
def test_run_multi_equals_jax_run_multi(key, bc):
    """Three chained passes of t = 4 in float32: bitwise."""
    jmod, pmod, shape, chunk, _ = FAMILIES[key]
    u0 = _field(shape, seed=30 + key)
    want = np.asarray(jmod.run_multi(jnp.asarray(u0), 12, bc=bc, t_steps=4,
                                     interpret=True, **chunk))
    got = pmod.run_multi(torch.from_numpy(u0), 12, bc=bc, t_steps=4)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("key", list(FAMILIES))
def test_plain_multi_equals_t_golden_steps_at_ragged_shapes(key, bc):
    """The plain version on shapes no TPU kernel takes, t = 5 (odd, and
    beyond the smallest extents) against the NumPy golden: bitwise."""
    pmod = FAMILIES[key][1]
    points = key if key == 9 else 0
    for shape in RAGGED[key]:
        u0 = _field(shape, seed=len(shape))
        want = pref.GOLDEN_RUNS[points](u0, 5, bc=bc)
        got = pmod.step_multi_plain(torch.from_numpy(u0), bc, 5)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("key", list(FAMILIES))
def test_plain_multi_narrows_once(key):
    """bfloat16: the t-step plain pass is t float32 steps rounded once,
    not t single steps each rounded (those differ on this field)."""
    pmod = FAMILIES[key][1]
    u = torch.from_numpy(_field(FAMILIES[key][2], seed=50)).bfloat16()
    once = pmod.step_multi_plain(u, "periodic", 4)
    want = pmod.step_multi_plain(u.float(), "periodic", 4).bfloat16()
    assert once.dtype == torch.bfloat16 and torch.equal(once, want)
    assert not torch.equal(once, run_steps(pmod.step_plain, u, 4,
                                           "periodic"))
    out = torch.empty_like(u)
    assert pmod.step_multi(u, "periodic", 4, out=out) is out
    assert torch.equal(out, once)


def test_library_refuses_what_jax_refuses():
    u1 = _field((8192,))
    u2 = _field((64, 256))
    for jmod, pmod, u in ((j1, p1, u1), (j2, p2, u2), (j9, p9, u2)):
        with pytest.raises(ValueError, match="t_steps"):
            jmod.step_pallas_multi(jnp.asarray(u), t_steps=0,
                                   interpret=True)
        with pytest.raises(ValueError, match="t_steps must be >= 1"):
            pmod.step_multi(torch.from_numpy(u), t_steps=0)
        with pytest.raises(ValueError) as ref:
            jmod.run_multi(jnp.asarray(u), 10, t_steps=8, interpret=True)
        with pytest.raises(ValueError) as port:
            pmod.run_multi(torch.from_numpy(u), 10, t_steps=8)
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="t_steps must be >= 1"):
        run_steps_multi(p1.step_multi, torch.from_numpy(u1), 8, "periodic",
                        0)
    # temporal blocking for the 3D star (the wavefront), none for the
    # 27-point box (none in JAX either)
    assert hasattr(kernels_for(3), "run_multi")
    assert not hasattr(kernels_for(3, 27), "run_multi")


@pytest.mark.parametrize("tile", [(1, 1), (3, 5), (40, 72), (7, 300),
                                  (128, 32), (1 << 12, 1 << 12)])
@pytest.mark.parametrize("t", [1, 4, 8])
def test_any_2d_tile_fits_a_block(tile, t):
    """A 2D block is one warp that walks its tile in strips, its levels in
    registers: no tile of at least one cell is refused; a tile below one
    cell is refused."""
    from tpu_comm_torch.kernels import tiling

    tiling.check_multi_tile(2, tile, t)
    with pytest.raises(ValueError, match="tile must be >= 1"):
        tiling.check_multi_tile(2, (0, tile[1]), t)


def test_default_2d_tile_is_one_strip_at_the_main_t():
    """The default 2D tile's columns are one warp's strip at t = 8: 32
    lanes of 4 columns less the apron of 8 a side."""
    rows, cols = p2.MULTI_DEFAULT_TILE
    assert cols + 2 * 8 == 32 * 4
    assert p2.default_multi_chunk((8192, 8192)) == rows
    assert p9.default_multi_chunk((8192, 8192)) == rows


def test_run_multi_of_zero_iters_copies_the_field():
    u = torch.from_numpy(_field((64, 64)))
    got = p2.run_multi(u, 0, t_steps=8)
    assert torch.equal(got, u) and got.data_ptr() != u.data_ptr()


#: (family, driver size, the JAX chunk)
DRIVER = {1: (1, 8192, 8), 2: (2, 128, 16), 9: (2, 128, 16)}


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("key", list(DRIVER))
def test_driver_dump_matches_jax_driver(tmp_path, key, bc):
    """``run_single_device`` of both packages, ``--iters 16 --t-steps 8``
    from one ``--load`` file: bitwise dumps, the port's row verified."""
    dim, size, chunk = DRIVER[key]
    points = key if key == 9 else 0
    load = tmp_path / "u0.npy"
    np.save(load, _field((size,) * dim, seed=60 + key))
    common = dict(dim=dim, points=points, size=size, iters=16, t_steps=8,
                  bc=bc, load=str(load), warmup=1, reps=1)
    jstencil.run_single_device(jstencil.StencilConfig(
        impl="pallas-multi", backend="cpu-sim", chunk=chunk,
        dump=str(tmp_path / "a.npy"), **common))
    path = tmp_path / "rows.jsonl"
    rec = pstencil.run_single_device(pstencil.StencilConfig(
        impl="multi", backend="cpu", verify=True, verify_iters=5,
        dump=str(tmp_path / "b.npy"), jsonl=str(path), **common))
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"),
                                  np.load(tmp_path / "a.npy"))
    assert (rec["impl"], rec["t_steps"], rec["verified"]) == ("multi", 8,
                                                             True)
    assert rec["chunk_source"] == "auto"
    errors, warnings = validate_row(json.loads(path.read_text()))
    assert errors == [] and warnings == []


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("key", list(DRIVER))
def test_sub_fp32_multi_verifies_against_golden(key, dtype):
    """One rounding a pass instead of one a step: inside the JAX
    driver's envelope (verify iterations rounded up to 8)."""
    dim = DRIVER[key][0]
    rec = pstencil.run_single_device(pstencil.StencilConfig(
        dim=dim, points=key if key == 9 else 0, size=64, iters=8,
        impl="multi", dtype=dtype, bc="periodic", backend="cpu",
        verify=True, verify_iters=5, warmup=1, reps=1))
    assert rec["verified"] and rec["dtype"] == dtype


def test_cli_row_carries_t_steps_and_passes_the_jax_row_schema(tmp_path):
    path = tmp_path / "rows.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "tpu_comm_torch", "stencil", "--backend",
         "cpu", "--dim", "2", "--size", "64", "--iters", "16", "--impl",
         "multi", "--t-steps", "4", "--verify", "--reps", "7", "--jsonl",
         str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    row = json.loads(path.read_text())
    assert (row["workload"], row["impl"], row["t_steps"], row["verified"],
            row["platform"]) == ("stencil2d", "multi", 4, True, "cpu")
    assert validate_row(row) == ([], [])
    # the 2N-bytes-per-iteration convention: lattice updates, not wire
    # traffic
    assert row["gbps_eff"] == pytest.approx(
        2 * 64 * 64 * 4 / row["secs_per_iter"] / 1e9)


def test_cli_t_steps_defaults_to_jax_value():
    from tpu_comm import cli as jcli

    args = cli.build_parser().parse_args(["stencil"])
    jargs = jcli.build_parser().parse_args(["stencil"])
    assert args.t_steps == jargs.t_steps == 8
    assert pstencil.StencilConfig().t_steps == 8


@pytest.mark.parametrize("argv,message", [
    (["--dim", "2", "--iters", "12"],
     "--iters (12) must be a multiple of --t-steps (8)"),
    (["--dim", "2", "--iters", "16", "--tol", "0.1"],
     "--tol convergence mode and --impl multi are exclusive"),
    (["--dim", "3", "--iters", "16", "--bc", "periodic"],
     "--impl multi in 3D (wavefront temporal blocking) supports --bc "
     "dirichlet only"),
    (["--points", "27", "--dim", "3", "--iters", "16"],
     "not available for --points 27"),
    (["--dim", "2", "--iters", "16", "--t-steps", "0"],
     "--t-steps must be >= 1"),
    (["--dim", "2", "--iters", "16", "--mesh", "2,2", "--tol", "0.1"],
     "--tol convergence mode and --impl multi are exclusive"),
    (["--dim", "2", "--iters", "12", "--mesh", "2,2"],
     "--iters (12) must be a multiple of --t-steps (8)"),
])
def test_cli_refuses_what_jax_refuses(capsys, argv, message):
    rc = cli.main(["stencil", "--backend", "cpu", "--size", "64",
                   "--impl", "multi", *argv])
    assert rc == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("argv,message", [
    (["--dim", "2", "--iters", "12"], "must be a multiple of --t-steps"),
    (["--dim", "2", "--iters", "16", "--tol", "0.1"],
     "--tol convergence mode and pallas-multi are exclusive"),
    (["--points", "27", "--dim", "3", "--iters", "16"],
     "not available for --points 27"),
])
def test_jax_driver_refuses_the_same(argv, message):
    """The cases above are the JAX driver's own refusals."""
    args = cli.build_parser().parse_args(["stencil", *argv])
    with pytest.raises(ValueError, match=message.replace("(", r"\(")
                       .replace(")", r"\)")):
        jstencil.run_single_device(jstencil.StencilConfig(
            dim=args.dim, points=args.points, size=64, iters=args.iters,
            tol=args.tol, impl="pallas-multi", backend="cpu-sim"))
