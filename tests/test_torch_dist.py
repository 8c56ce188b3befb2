"""The port's distributed stencil held against the JAX package's, on the
CPU: the local step of every arm, the convergence loop, the benchmark
entry point, its row and its CLI.

The same seeded NumPy field goes through both packages: JAX decomposes
it over cpu-sim devices and runs ``run_distributed`` (Pallas kernels in
interpret mode, as the JAX package's own tests run them); the port
decomposes it over 4 ``gloo`` ranks, started once for this file with
every case in that one spawn (``torch_mesh_cases.run_cases``), and over a
world of one in process.

Contract: the gathered field is bitwise equal to JAX's for every arm x
dim x bc in float32 AND in bfloat16 (bound: 0 ulps per step; the arms
round where JAX's do, since the face recompute, the ``torch`` and
``overlap`` arithmetic run in the field's dtype with ``1/(2d)`` rounded
to it, and the kernels' plain versions compute in float32 and narrow
once, as the Pallas kernels do).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

import torch_mesh_cases as cases
from tpu_comm.analysis.rowschema import validate_row
from tpu_comm.bench import stencil as jstencil
from tpu_comm.comm import halo as jhalo
from tpu_comm.domain import Decomposition as JDecomposition
from tpu_comm.kernels import distributed as jdist
from tpu_comm.topo import make_cart_mesh as jmake_cart_mesh
from tpu_comm_torch import cli
from tpu_comm_torch.bench import stencil as pstencil
from tpu_comm_torch.bench.timing import emit_jsonl
from tpu_comm_torch.comm import launch
from tpu_comm_torch.domain import Decomposition
from tpu_comm_torch.kernels import distributed as pdist
from tpu_comm_torch.kernels.tiling import DTYPES, to_numpy_field
from tpu_comm_torch.topo import make_cart_mesh

ROOT = Path(__file__).resolve().parents[1]
#: global shape and mesh per dim: local blocks the TPU kernels accept
LAYOUTS = {
    1: ((4096,), (4,)),
    2: ((16, 256), (2, 2)),
    3: ((8, 16, 128), (2, 2, 1)),
}
#: the port's arm -> the JAX package's
JAX_IMPL = {"torch": "lax", "overlap": "overlap", "block": "pallas",
            "stream": "pallas-stream"}
#: the JAX stream arm's chunk on these local blocks
JAX_STREAM_CHUNK = {1: {"rows_per_chunk": 8}, 2: {"rows_per_chunk": 8},
                    3: {"planes_per_chunk": 2}}
ITERS = 3
RUNS = [
    (dim, bc, impl, dtype, pack)
    for dim in LAYOUTS
    for bc in ("dirichlet", "periodic")
    for impl in JAX_IMPL
    for dtype in ("float32", "bfloat16")
    for pack in (("fused", "kernel") if dim == 3 and impl != "torch"
                 else ("fused",))
]
CONV = {"tol": 2.5, "max_iters": 60, "check_every": 4}


def _jax_kwargs(dim, impl, pack):
    kw = {}
    if impl in ("block", "stream") or pack == "kernel":
        kw["interpret"] = True
    if pack == "kernel":
        kw["pack"] = "pallas"
    if impl == "stream":
        kw.update(JAX_STREAM_CHUNK[dim])
    return kw


def _jax_setup(u0, mesh, bc, dtype):
    cart = jmake_cart_mesh(u0.ndim, backend="cpu-sim", shape=mesh,
                           periodic=bc == "periodic")
    dec = JDecomposition(cart, u0.shape)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return dec, dec.scatter(jnp.asarray(u0).astype(jdt))


def _jax_run(u0, mesh, iters, bc, impl, dtype="float32", pack="fused"):
    dec, u = _jax_setup(u0, mesh, bc, dtype)
    out = jdist.run_distributed(u, dec, iters, bc, JAX_IMPL[impl],
                                **_jax_kwargs(u0.ndim, impl, pack))
    return np.asarray(dec.gather(out).astype(np.float32))


@pytest.fixture(scope="module")
def ranks():
    todo = {}
    for dim, bc, impl, dtype, pack in RUNS:
        gshape, mesh = LAYOUTS[dim]
        todo["run", dim, bc, impl, dtype, pack] = ("run", {
            "u0": cases.field(gshape, dim), "mesh": mesh, "iters": ITERS,
            "bc": bc, "impl": impl, "dtype": dtype, "pack": pack,
        })
    for bc in ("dirichlet", "periodic"):
        for impl in ("overlap", "block"):
            todo["conv", bc, impl] = ("conv", {
                "u0": cases.field(LAYOUTS[2][0], 8), "mesh": LAYOUTS[2][1],
                "bc": bc, "impl": impl, **CONV,
            })
    for dim, (gshape, mesh) in LAYOUTS.items():
        todo["freeze", dim] = ("freeze", {"u0": cases.field(gshape, dim),
                                          "mesh": mesh})
    todo["verdict"] = ("verdict", {})
    common = dict(dim=2, size=64, iters=4, mesh=(2, 2), backend="cpu",
                  warmup=1, reps=5, verify=True, verify_iters=3)
    todo["bench"] = ("bench", {**common, "impl": "auto"})
    todo["bench-conv"] = ("bench", {**common, "impl": "block", "tol": 0.5,
                                    "check_every": 5, "iters": 50})
    # one thread per rank: four ranks run beside the other test workers
    with pytest.MonkeyPatch.context() as env:
        env.setenv("OMP_NUM_THREADS", "1")
        return launch.run_ranks(cases.run_cases, 4, "gloo", (todo,),
                                timeout_s=300)


@pytest.mark.parametrize("dim,bc,impl,dtype,pack", RUNS)
def test_mesh_run_equals_jax_bitwise(ranks, dim, bc, impl, dtype, pack):
    gshape, mesh = LAYOUTS[dim]
    want = _jax_run(cases.field(gshape, dim), mesh, ITERS, bc, impl, dtype,
                    pack)
    got = ranks["run", dim, bc, impl, dtype, pack]
    assert all(g is None for g in got[1:])
    assert got[0].dtype == np.float32 and got[0].shape == gshape
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("impl", list(JAX_IMPL))
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_world_of_one_equals_jax_bitwise(dim, bc, impl):
    """The mesh of one rank (what a single card runs): a periodic axis
    wraps onto its own rank. No process group is needed for it."""
    gshape = {1: (1024,), 2: (8, 128), 3: (4, 8, 128)}[dim]
    u0 = cases.field(gshape, 20 + dim)
    pack = "kernel" if dim == 3 and impl != "torch" else "fused"
    want = _jax_run(u0, (1,) * dim, ITERS, bc, impl, pack=pack)
    dec = Decomposition(
        make_cart_mesh(dim, periodic=bc == "periodic"), gshape
    )
    block = dec.scatter(u0)
    keep = block.clone()
    got = pdist.run_distributed(block, dec, ITERS, bc=bc, impl=impl,
                                pack=pack)
    np.testing.assert_array_equal(dec.gather(got), want)
    assert (block == keep).all()  # the input block is only read


@pytest.mark.parametrize("impl", ["overlap", "block"])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_convergence_loop_stops_where_jax_stops(ranks, bc, impl):
    u0 = cases.field(LAYOUTS[2][0], 8)
    dec, u = _jax_setup(u0, LAYOUTS[2][1], bc, "float32")
    kw = {"interpret": True} if impl == "block" else {}
    want, want_it, want_res = jdist.run_distributed_to_convergence(
        u, dec, CONV["tol"], CONV["max_iters"],
        check_every=CONV["check_every"], bc=bc, impl=JAX_IMPL[impl], **kw,
    )
    assert CONV["check_every"] < want_it < CONV["max_iters"]
    per_rank = ranks["conv", bc, impl]
    # every rank took the same stopping decision on the same residual
    assert {(it, res) for _, it, res in per_rank} == {per_rank[0][1:]}
    got, it, res = per_rank[0]
    assert it == want_it
    assert res == pytest.approx(want_res, rel=1e-5) and res <= CONV["tol"]
    np.testing.assert_array_equal(got, np.asarray(dec.gather(want)))


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_face_wise_freeze_equals_the_mask_form(ranks, dim):
    mesh = LAYOUTS[dim][1]
    for rank, (same, cells) in enumerate(ranks["freeze", dim]):
        assert same, f"rank {rank}"
        coords = np.unravel_index(rank, mesh)
        on_edge = any(c in (0, p - 1) for c, p in zip(coords, mesh))
        assert (cells > 0) == on_edge  # 1D ranks 1 and 2 freeze nothing


def test_verdict_of_rank_0_is_raised_on_every_rank(ranks):
    assert ranks["verdict"] == ["verification FAILED: injected"] + [
        "verification FAILED (the verdict of rank 0)"] * 3


def test_rows_pass_the_jax_row_schema(ranks):
    rows = [ranks["bench"], ranks["bench-conv"]]
    for per_rank in rows:
        assert all(r is None for r in per_rank[1:])
    row, conv = (per_rank[0] for per_rank in rows)
    for r in (row, conv):
        errors, warnings = validate_row(json.loads(emit_jsonl(r)))
        assert errors == [] and warnings == []
        assert (r["mesh"], r["topo_plan"], r["pack"], r["local_size"]) == (
            [2, 2], None, "fused", [32, 32])
        assert r["platform"] == "cpu" and r["verified"] is True
        jcart = jmake_cart_mesh(2, backend="cpu-sim", shape=(2, 2))
        assert r["halo_bytes_per_chip_per_iter"] == jhalo.halo_bytes_per_iter(
            (32, 32), jcart, 4) == 2 * 2 * 32 * 4
        if r.get("below_timing_resolution"):
            # a slope lost in a busy machine's noise is reported as null
            assert r["halo_gbps_per_chip"] is None and r["gbps_eff"] is None
            continue
        assert r["halo_gbps_per_chip"] == pytest.approx(
            r["halo_bytes_per_chip_per_iter"] / r["secs_per_iter"] / 1e9)
        assert r["gbps_eff"] == pytest.approx(
            2 * 32 * 32 * 4 / r["secs_per_iter"] / 1e9)
    assert (row["workload"], row["impl"]) == ("stencil2d-dist", "overlap")
    assert (conv["workload"], conv["impl"]) == ("stencil2d-dist-conv",
                                                "block")
    assert conv["converged"] and conv["iters"] < 50


DRIVER = [
    (1, 4096, (4,), "block", "fused", "dirichlet"),
    (2, 256, (2, 2), "torch", "fused", "periodic"),
    (2, 256, (2, 2), "overlap", "fused", "dirichlet"),
    (3, 128, (2, 2, 1), "block", "kernel", "periodic"),
    (3, 128, (2, 2, 1), "stream", "fused", "dirichlet"),
]


@pytest.mark.parametrize("dim,size,mesh,impl,pack,bc", DRIVER)
def test_driver_dump_equals_jax_driver(tmp_path, dim, size, mesh, impl, pack,
                                       bc):
    """``run_distributed_bench`` of both packages from one ``--load``
    file: the port starts its own 4 ranks."""
    load = tmp_path / "u0.npy"
    np.save(load, cases.field((size,) * dim, 30 + dim))
    common = dict(dim=dim, size=size, iters=2, bc=bc, mesh=mesh,
                  load=str(load), warmup=1, reps=1)
    jstencil.run_distributed_bench(jstencil.StencilConfig(
        impl=JAX_IMPL[impl], backend="cpu-sim",
        pack={"fused": "fused", "kernel": "pallas"}[pack],
        dump=str(tmp_path / "a.npy"), **common,
    ))
    rec = pstencil.run_distributed_bench(pstencil.StencilConfig(
        impl=impl, backend="cpu", pack=pack, verify=True, verify_iters=3,
        dump=str(tmp_path / "b.npy"), dist_timeout=240, **common,
    ))
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"),
                                  np.load(tmp_path / "a.npy"))
    assert rec["workload"] == f"stencil{dim}d-dist" and rec["verified"]
    assert (rec["impl"], rec["pack"], rec["mesh"]) == (impl, pack, list(mesh))


def _run_cli(*argv, env=None, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", *argv], cwd=ROOT, capture_output=True,
        text=True, timeout=timeout, env=env,
    )


def test_cli_on_a_mesh_equals_the_jax_cli(tmp_path):
    """``--load in.npy --dump out.npy --mesh 2,2 --verify`` through both
    command lines; the port's row passes the JAX row schema."""
    load, a, b = (tmp_path / n for n in ("in.npy", "a.npy", "b.npy"))
    np.save(load, cases.field((256, 256), 40))
    common = ["stencil", "--dim", "2", "--size", "256", "--mesh", "2,2",
              "--iters", "2", "--warmup", "1", "--reps", "1", "--verify",
              "--load", str(load)]
    ref = _run_cli("tpu_comm.cli", *common, "--backend", "cpu-sim", "--dump",
                   str(a))
    assert ref.returncode == 0, ref.stderr
    res = _run_cli("tpu_comm_torch", *common, "--backend", "cpu", "--dump",
                   str(b), "--jsonl", str(tmp_path / "rows.jsonl"),
                   "--verify-iters", "5")
    assert res.returncode == 0, res.stderr
    np.testing.assert_array_equal(np.load(b), np.load(a))
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1  # rank 0 prints the one row
    row = json.loads(lines[0])
    banked = json.loads((tmp_path / "rows.jsonl").read_text())
    errors, warnings = validate_row(banked)
    assert errors == [] and warnings == []
    jrow = json.loads(ref.stdout.strip().splitlines()[-1])
    for key in ("workload", "impl", "mesh", "pack", "bc", "dtype", "size",
                "local_size", "iters", "halo_bytes_per_chip_per_iter",
                "verified", "topo_plan"):
        assert row[key] == banked[key] == jrow[key], key
    assert row["impl"] == "overlap"  # auto on a mesh


def test_cli_failed_verify_on_4_ranks_exits_nonzero_and_prints_no_row(
        tmp_path):
    """A field with a NaN can match no golden: rank 0's verdict reaches
    every rank, the command exits non-zero within its limit, no row."""
    u0 = cases.field((64, 64), 41)
    u0[10, 10] = np.nan
    np.save(tmp_path / "nan.npy", u0)
    res = _run_cli(
        "tpu_comm_torch", "stencil", "--backend", "cpu", "--dim", "2",
        "--size", "64", "--mesh", "2,2", "--iters", "2", "--verify",
        "--verify-iters", "2", "--load", str(tmp_path / "nan.npy"),
        "--jsonl", str(tmp_path / "rows.jsonl"), "--dist-timeout", "90",
        timeout=150,
    )
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "verification FAILED" in res.stderr
    assert not (tmp_path / "rows.jsonl").exists()


def test_cli_joins_the_group_a_launcher_gives_it(tmp_path):
    """With RANK and WORLD_SIZE set (as ``torchrun`` sets them) each
    process is one rank; rank 0 alone prints the row."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "tpu_comm_torch", "stencil", "--backend",
            "cpu", "--dim", "1", "--size", "4096", "--mesh", "2", "--iters",
            "2", "--warmup", "1", "--reps", "1", "--verify", "--impl",
            "block", "--bc", "periodic", "--dist-timeout", "90"]
    procs = [
        subprocess.Popen(
            argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
            env={**os.environ, "RANK": str(rank), "WORLD_SIZE": "2",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)},
        )
        for rank in range(2)
    ]
    try:
        outs = [p.communicate(timeout=150) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    row = json.loads(outs[0][0])
    assert (row["mesh"], row["impl"], row["verified"]) == ([2], "block", True)
    assert outs[1][0].strip() == ""


@pytest.mark.parametrize("argv,message", [
    (["--dim", "2", "--size", "63", "--mesh", "2,2"],
     "global dim 63 not divisible by mesh axis 'x' size 2"),
    (["--dim", "2", "--size", "64", "--mesh", "2,2", "--chunk", "8"],
     "--chunk is a single-device tuning knob"),
    (["--dim", "2", "--size", "64", "--mesh", "2,2", "--pack", "kernel",
      "--impl", "block"], "pack='kernel' needs a 3D mesh"),
    (["--dim", "3", "--size", "16", "--mesh", "2,2,1", "--pack", "kernel",
      "--impl", "torch"], "pack='kernel' needs a 3D mesh and impl="),
    (["--dim", "3", "--size", "16", "--mesh", "2,2,1", "--pack", "pallas"],
     "--pack pallas is the JAX package's name; the port calls it 'kernel'"),
    (["--dim", "2", "--size", "64", "--mesh", "2,2", "--impl", "pallas"],
     "--impl pallas is the JAX package's name; the port calls this arm "
     "'block'"),
    (["--dim", "2", "--size", "64", "--mesh", "2,2", "--impl", "lax"],
     "the port calls this arm 'torch'"),
    (["--dim", "2", "--size", "64", "--mesh", "2,2", "--impl",
      "partitioned"], "not yet ported; see ROADMAP.md"),
    (["--dim", "2", "--size", "64", "--mesh", "4"], "has 1 axes, --dim is 2"),
    (["--dim", "2", "--size", "64", "--mesh", "2,0"], "positive sizes"),
    (["--dim", "2", "--size", "64", "--impl", "torch"],
     "--impl torch is an arm of a mesh run: pass --mesh"),
    (["--dim", "3", "--size", "16", "--pack", "kernel"],
     "--pack applies to a 3D mesh run"),
])
def test_cli_refuses_bad_mesh_runs_before_it_starts_a_rank(capsys, argv,
                                                           message):
    rc = cli.main(["stencil", "--backend", "cpu", "--iters", "2", *argv])
    assert rc == 2
    assert message in capsys.readouterr().err


def test_library_refuses_what_jax_refuses():
    cart = make_cart_mesh(2, shape=(2, 2), world=4, rank=0)
    jcart = jmake_cart_mesh(2, backend="cpu-sim", shape=(2, 2))
    with pytest.raises(ValueError) as port:
        pdist.make_local_step(cart, "periodic", "overlap")
    with pytest.raises(ValueError) as ref:
        jdist.make_local_step(jcart, "periodic", "overlap")
    assert str(port.value) == str(ref.value)
    for kwargs, message in [
        ({"stencil": "9pt"}, "not yet ported"),
        ({"halo_wire": "bfloat16"}, "halo_wire is not yet ported"),
        ({"t_steps": 4}, "t_steps is not yet ported"),
        ({"rows": 3}, "unknown kwargs"),
    ]:
        with pytest.raises(ValueError, match=message):
            pdist.make_local_step(cart, "dirichlet", "overlap", **kwargs)
    with pytest.raises(ValueError, match="unknown distributed impl"):
        pdist.make_local_step(cart, "dirichlet", "nope")
    dec = Decomposition(cart, (16, 16))
    import torch

    with pytest.raises(ValueError, match="block shape"):
        pdist.run_distributed(torch.zeros(16, 16), dec, 1)
    with pytest.raises(ValueError, match="check_every must be >= 1"):
        pdist.run_distributed_to_convergence(
            torch.zeros(8, 8), dec, 0.1, 10, check_every=0)


def test_stencil_from_padded_and_dtype_constant_equal_jax():
    p = cases.field((6, 7, 9), 50)
    import torch

    for dtype, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        want = jdist.stencil_from_padded(jnp.asarray(p).astype(jdt))
        got = pdist.stencil_from_padded(torch.from_numpy(p).to(DTYPES[dtype]))
        np.testing.assert_array_equal(
            to_numpy_field(got), np.asarray(want.astype(jnp.float32)))
