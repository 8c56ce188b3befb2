"""The port's ``pack`` subcommand (the face-pack microbenchmark) and
``unpack_ghosts_3d`` held against the JAX package, on the CPU.

- ``face_bytes`` and ``pack_bytes_per_iter`` equal JAX's (the port's
  ``fused``/``kernel`` arms for JAX's ``lax``/``pallas``).
- A row carries the JAX row's fields, equal where they do not name an
  arm or a measurement, passes the JAX row schema, and under the test's
  clock (``torch_fake_clock``) its rates are its bytes over the slope.
- ``pad_block_3d`` and ``unpack_ghosts_3d`` equal JAX's bitwise.
- The CLI: JAX's defaults, JAX's arm names and ``--chunk``/``--dimsem``
  refused with exit 2.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_comm import cli as jcli
from tpu_comm.analysis.rowschema import validate_row
from tpu_comm.bench import packbench as jpack
from tpu_comm.kernels import pack as jpackmod
from tpu_comm_torch import cli
from tpu_comm_torch.bench import packbench as ppack
from tpu_comm_torch.bench.timing import emit_jsonl
from tpu_comm_torch.kernels import pack as ppackmod
from tpu_comm_torch.kernels.tiling import DTYPES, to_numpy_field
from torch_fake_clock import PER_ITER_S, fake_clock

JAX_ARM = {"fused": "lax", "kernel": "pallas"}
SHAPES = [(4, 8, 16), (1, 1, 1), (3, 5, 7), (128, 128, 512)]
#: the JAX row's fields that name its arm or a measurement of its own,
#: on the machine's clock (its phases hold a compile time; its pallas arm
#: runs interpreted here)
NOT_IDENTITY = {"workload", "backend", "phases", "interpret_mode",
                "gbps_eff", "gbps_faces", "secs_per_iter",
                "below_timing_resolution"}


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arm", list(JAX_ARM))
def test_byte_models_equal_jax(arm, shape, itemsize):
    assert ppack.face_bytes(*shape, itemsize) == jpack.face_bytes(
        *shape, itemsize)
    assert ppack.pack_bytes_per_iter(*shape, itemsize, impl=arm) == \
        jpack.pack_bytes_per_iter(*shape, itemsize, impl=JAX_ARM[arm])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arm", list(JAX_ARM))
def test_rows_carry_jax_fields(tmp_path, arm, dtype):
    path = tmp_path / "rows.jsonl"
    shape = dict(nz=4, ny=8, nx=16)
    with fake_clock():
        row = ppack.run_pack_bench(ppack.PackConfig(
            impl=arm, backend="cpu", dtype=dtype, iters=2, warmup=1,
            reps=1, jsonl=str(path), **shape))
    jrow = jpack.run_pack_bench(jpack.PackConfig(
        impl=JAX_ARM[arm], backend="cpu-sim", dtype=dtype, iters=2,
        warmup=1, reps=1, **shape))
    assert set(jrow) <= set(row)
    for key in set(jrow) - NOT_IDENTITY:
        if not key.startswith("t_"):  # the timing summary
            assert row[key] == jrow[key], key
    assert (row["workload"], row["impl"], row["platform"],
            row["dispatch"]) == (f"pack3d-{arm}", arm, "cpu", "eager")
    assert validate_row(json.loads(path.read_text())) == ([], [])
    item = 4 if dtype == "float32" else 2
    nbytes = ppack.pack_bytes_per_iter(4, 8, 16, item, impl=arm)
    assert row["secs_per_iter"] == PER_ITER_S
    assert row["gbps_eff"] == nbytes / PER_ITER_S / 1e9
    assert row["gbps_faces"] == (
        ppack.face_bytes(4, 8, 16, item) / PER_ITER_S / 1e9)
    assert row["verified"] is True
    assert validate_row(json.loads(emit_jsonl(row))) == ([], [])


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("arm", list(JAX_ARM))
def test_each_arm_packs_the_six_faces(arm, shape):
    u = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape)
    got = ppack.pack_once(u, arm)
    want = jpackmod.pack_faces_3d_lax(jnp.asarray(u.numpy()))
    assert len(got) == 6
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_a_wrong_pack_fails_verification(monkeypatch):
    def wrong(u, impl):
        return tuple(torch.zeros_like(f).contiguous()
                     for f in ppackmod.pack_faces_3d(u, "fused"))

    monkeypatch.setattr(ppack, "pack_once", wrong)
    with pytest.raises(AssertionError, match="face z_lo"):
        ppack.run_pack_bench(ppack.PackConfig(backend="cpu", nz=2, ny=3,
                                              nx=4, iters=1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_unpack_ghosts_3d_equals_jax(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    nz, ny, nx = shape
    padded = rng.standard_normal((nz + 2, ny + 2, nx + 2)).astype(
        np.float32)
    faces = [rng.standard_normal(s).astype(np.float32) for s in (
        (ny, nx), (ny, nx), (nz, nx), (nz, nx), (nz, ny), (nz, ny))]
    jdt, tdt = getattr(jnp, dtype), DTYPES[dtype]
    want = jpackmod.unpack_ghosts_3d(jnp.asarray(padded, jdt),
                                     [jnp.asarray(f, jdt) for f in faces])
    src = torch.from_numpy(padded).to(tdt)
    got = ppackmod.unpack_ghosts_3d(
        src, [torch.from_numpy(f).to(tdt) for f in faces])
    np.testing.assert_array_equal(
        to_numpy_field(got), np.asarray(want.astype(jnp.float32)))
    # the input is not written
    assert torch.equal(src, torch.from_numpy(padded).to(tdt))


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_pad_block_3d_equals_jax(shape):
    u = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(
        ppackmod.pad_block_3d(torch.from_numpy(u)).numpy(),
        np.asarray(jpackmod.pad_block_3d(jnp.asarray(u))))


def test_unpack_refuses_a_block_that_is_not_3d():
    with pytest.raises(ValueError, match="padded 3-D block"):
        ppackmod.unpack_ghosts_3d(torch.zeros(4, 4), [None] * 6)


# ------------------------------------------------------ CLI

def test_cli_defaults_follow_jax():
    args = cli.build_parser().parse_args(["pack"])
    jargs = jcli.build_parser().parse_args(["pack"])
    for name in ("nz", "ny", "nx", "impl", "dtype", "chunk", "dimsem",
                 "iters", "warmup", "reps", "no_verify", "jsonl"):
        assert getattr(args, name) == getattr(jargs, name), name


def test_cli_both_prints_a_row_an_arm(capsys):
    with fake_clock():
        rc = cli.main(["pack", "--backend", "cpu", "--nz", "3", "--ny", "4",
                       "--nx", "5", "--iters", "2", "--reps", "1"])
    assert rc == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["workload"] for r in rows] == ["pack3d-fused", "pack3d-kernel"]
    assert all(r["verified"] and r["size"] == [3, 4, 5] for r in rows)


@pytest.mark.parametrize("argv,message", [
    (["--impl", "lax"], "--impl lax is the JAX package's name; the port "
     "calls this arm 'fused'"),
    (["--impl", "pallas"], "--impl pallas is the JAX package's name; the "
     "port calls this arm 'kernel'"),
    (["--chunk", "128"], "--chunk and --dimsem"),
    (["--dimsem", "parallel"], "--chunk and --dimsem"),
    (["--impl", "slices"], "impl must be one of"),
    (["--nz", "0"], "every extent must be >= 1"),
    (["--iters", "0"], "--iters must be >= 1"),
])
def test_cli_refusals_exit_2(capsys, argv, message):
    assert cli.main(["pack", "--backend", "cpu", *argv]) == 2
    assert message in capsys.readouterr().err
