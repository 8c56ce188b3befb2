"""The port's whole slice held against the JAX package, on the CPU: the
single-device stencil driver, its ``--tol`` mode, its rows and its CLI."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpu_comm.analysis.rowschema import validate_row
from tpu_comm.bench import stencil as jstencil
from tpu_comm.kernels import reference as jref
from tpu_comm_torch import cli
from tpu_comm_torch.bench import stencil as pstencil

ROOT = Path(__file__).resolve().parents[1]
#: (size, chunk) per dim: small enough for interpret mode, chunked so
#: the JAX arm crosses chunk seams
DRIVER = {1: (8192, 8), 2: (128, 16), 3: (128, 8)}


def _jax_cfg(**kw):
    return jstencil.StencilConfig(
        impl="pallas-stream", backend="cpu-sim", warmup=1, reps=1, **kw
    )


def _port_cfg(**kw):
    return pstencil.StencilConfig(**{"backend": "cpu", "warmup": 1,
                                     "reps": 1, **kw})


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_driver_dump_matches_jax_driver(tmp_path, dim, bc):
    size, chunk = DRIVER[dim]
    load = tmp_path / "u0.npy"
    np.save(load, jref.init_field((size,) * dim, kind="random", seed=dim))
    common = dict(dim=dim, size=size, iters=4, bc=bc, chunk=chunk,
                  load=str(load))
    jstencil.run_single_device(_jax_cfg(dump=str(tmp_path / "a.npy"),
                                        **common))
    rec = pstencil.run_single_device(_port_cfg(
        dump=str(tmp_path / "b.npy"), verify=True, verify_iters=4, **common
    ))
    a, b = np.load(tmp_path / "a.npy"), np.load(tmp_path / "b.npy")
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(b, a)
    assert rec["workload"] == f"stencil{dim}d" and rec["verified"]
    assert (rec["impl"], rec["platform"], rec["chunk"]) == ("stream", "cpu",
                                                            chunk)


def test_tol_mode_stops_with_jax_driver_and_golden(tmp_path):
    common = dict(dim=2, size=128, iters=200, tol=0.4, check_every=5)
    _, want_iters, _ = jref.jacobi_run_to_convergence(
        jref.init_field((128, 128)), 0.4, 200, check_every=5
    )
    assert 5 < want_iters < 200
    jrec = jstencil.run_single_device(_jax_cfg(
        chunk=16, dump=str(tmp_path / "a.npy"), **common
    ))
    prec = pstencil.run_single_device(_port_cfg(
        verify=True, dump=str(tmp_path / "b.npy"), **common
    ))
    assert jrec["iters"] == prec["iters"] == want_iters
    assert prec["workload"] == "stencil2d-conv" and prec["converged"]
    np.testing.assert_array_equal(
        np.load(tmp_path / "b.npy"), np.load(tmp_path / "a.npy")
    )


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_sub_fp32_driver_verifies_against_golden(tmp_path, dtype, bc):
    """bf16 runs the golden in float32 (NumPy has no bfloat16); both
    dtypes pass the JAX driver's envelope, and the dump is the field."""
    rec = pstencil.run_single_device(_port_cfg(
        dim=2, size=64, iters=4, dtype=dtype, bc=bc, verify=True,
        verify_iters=10, dump=str(tmp_path / "u.npy"),
    ))
    assert rec["verified"] and rec["dtype"] == dtype
    assert np.load(tmp_path / "u.npy").shape == (64, 64)


def test_row_passes_the_jax_row_schema(tmp_path):
    path = tmp_path / "rows.jsonl"
    for tol in (None, 0.5):
        # several reps: the slope of two single samples of so short a loop
        # can come out non-positive on a busy machine, and the rate then
        # null
        pstencil.run_single_device(_port_cfg(
            dim=1, size=4096, iters=4, tol=tol, jsonl=str(path), reps=7
        ))
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["workload"] for r in rows] == ["stencil1d", "stencil1d-conv"]
    for row in rows:
        errors, warnings = validate_row(row)
        assert errors == [] and warnings == []
        assert isinstance(row["gbps_eff"], float)
        assert row["gbps_eff"] == pytest.approx(
            2 * 4096 * 4 / row["secs_per_iter"] / 1e9
        )


def test_cli_runs_on_cpu(tmp_path):
    path = tmp_path / "rows.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "tpu_comm_torch", "stencil", "--backend",
         "cpu", "--dim", "2", "--size", "64", "--iters", "4", "--verify",
         "--jsonl", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    row = json.loads(path.read_text())
    assert (row["platform"], row["verified"], row["size"]) == (
        "cpu", True, [64, 64]
    )


def test_cli_default_backend_is_cuda_and_refuses_without_card(capsys):
    rc = cli.main(["stencil", "--dim", "2", "--size", "64", "--iters", "4"])
    assert rc == 2
    assert "backend=cuda requested but no CUDA device" in (
        capsys.readouterr().err
    )


#: what the CLI answers to each arm name it does not run on one device
#: (the extra flags a case needs)
REFUSED_IMPLS = {
    "lax": "the JAX package's name; the port calls this arm 'torch'",
    "wave": "wave supports bc='dirichlet' only, as JAX's pallas-wave",
    "pallas": "the JAX package's name; the port calls this arm 'block'",
    "pallas-stream": "the JAX package's name; the port calls this arm "
                     "'stream'",
    "pallas-grid": "the JAX package's name; the port calls this arm 'grid'",
    "pallas-wave": "the JAX package's name; the port calls this arm 'wave'",
    "pallas-multi": "the JAX package's name; the port calls this arm "
                    "'multi'",
    "partitioned": "is an arm of a mesh run: pass --mesh",
    "overlap": "is an arm of a mesh run: pass --mesh",
}
REFUSED_EXTRA = {"wave": ["--bc", "periodic"]}


@pytest.mark.parametrize("impl", ["lax", "wave", "pallas", "pallas-grid",
                                  "pallas-stream", "pallas-wave",
                                  "pallas-multi", "partitioned", "overlap"])
def test_cli_refuses_unported_impls(capsys, impl):
    """An arm the port has under another name is answered with that name,
    a mesh arm (``overlap``, ``partitioned``) with ``--mesh``, and the
    dirichlet-only ``wave`` under periodic with JAX's reason."""
    rc = cli.main(["stencil", "--backend", "cpu", "--dim", "1", "--size",
                   "1024", "--iters", "2", "--impl", impl,
                   *REFUSED_EXTRA.get(impl, [])])
    assert rc == 2
    assert REFUSED_IMPLS[impl] in capsys.readouterr().err


@pytest.mark.parametrize("impl", ["lax", "torch"])
def test_single_device_torch_arm_is_refused_by_both_names(capsys, impl):
    """JAX's ``lax`` arm is the port's ``torch`` arm on one device and on
    a mesh alike: ``lax`` is answered with the port's name in both modes,
    and ``torch`` runs in both, refused on one device only with a knob it
    does not take (``--chunk``)."""
    argv = ["stencil", "--backend", "cpu", "--dim", "2", "--size", "64",
            "--iters", "2", "--impl", impl]
    if impl == "lax":
        assert cli.main(argv) == 2
        err = capsys.readouterr().err
        assert "the port calls this arm 'torch'" in err
        assert "not yet ported" not in err
    else:
        assert cli.main(argv + ["--chunk", "8"]) == 2
        assert "--chunk applies to" in capsys.readouterr().err
        assert cli.main(argv) == 0
        assert json.loads(capsys.readouterr().out)["impl"] == "torch"
    cfg = pstencil.StencilConfig(dim=2, size=64, iters=2, impl=impl,
                                 mesh=(2, 2), backend="cpu")
    if impl == "lax":
        with pytest.raises(ValueError, match="the port calls this arm "
                                             "'torch'"):
            pstencil._validate_distributed(cfg)
    else:
        assert pstencil._validate_distributed(cfg).impl == "torch"


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_block_arm_driver_dump_matches_jax_pallas_arm(tmp_path, dim, bc):
    size = {1: 8192, 2: 128, 3: 128}[dim]
    load = tmp_path / "u0.npy"
    np.save(load, jref.init_field((size,) * dim, kind="random", seed=dim))
    common = dict(dim=dim, size=size, iters=4, bc=bc, load=str(load))
    jstencil.run_single_device(jstencil.StencilConfig(
        impl="pallas", backend="cpu-sim", warmup=1, reps=1,
        dump=str(tmp_path / "a.npy"), **common))
    rec = pstencil.run_single_device(_port_cfg(
        impl="block", dump=str(tmp_path / "b.npy"), verify=True,
        verify_iters=4, jsonl=str(tmp_path / "rows.jsonl"), **common))
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"),
                                  np.load(tmp_path / "a.npy"))
    assert rec["impl"] == "block" and "chunk" not in rec
    errors, warnings = validate_row(
        json.loads((tmp_path / "rows.jsonl").read_text()))
    assert errors == [] and warnings == []
    with pytest.raises(ValueError, match="--chunk applies to --impl stream"):
        pstencil.run_single_device(_port_cfg(impl="block", chunk=8, **common))


@pytest.mark.parametrize("flag", [
    ["--xprof", "prof"], ["--trace", "out.json"], ["--status", "s.jsonl"],
    ["--deadline", "2"], ["--max-retries", "2"],
    ["--dimsem", "parallel"], ["--backend", "cpu-sim"],
])
def test_cli_refuses_flags_it_does_not_port(flag):
    with pytest.raises(SystemExit) as e:
        cli.main(["stencil", "--dim", "2", "--size", "64", *flag])
    assert e.value.code == 2


def test_driver_refuses_bad_input(tmp_path):
    load = tmp_path / "u.npy"
    np.save(load, np.zeros((10, 10), np.float32))
    for cfg, msg in [
        (dict(dim=2, size=12, load=str(load)), "shape"),
        (dict(dim=1, size=2), "size must be >= 3"),
        (dict(dim=4, size=8), "dim must be"),
        (dict(dim=1, size=8, chunk=0), "chunk must be >= 1"),
        (dict(dim=1, size=8, dtype="float64"), "dtype must be one of"),
    ]:
        with pytest.raises(ValueError, match=msg):
            pstencil.run_single_device(_port_cfg(iters=2, **cfg))
