"""The port's collective sweep (``tpu_comm_torch/bench/sweep.py``) and its
``sweep`` subcommand held against the JAX package's, on the CPU.

- Every chained body of ``SWEEP_OPS`` (and ``allreduce-ring`` with a
  bfloat16 wire and float32 accumulation), applied once, in float32 and
  bfloat16, on 4 and 3 ``gloo`` ranks (one spawn each for this file,
  ``torch_coll_cases.run_cases``) and in a world of one in process,
  against JAX's ``_sweep_jit(x, cart, op, 1, ...)`` on the same seeded
  input over as many cpu-sim devices: bitwise for the ring, the
  broadcasts, ``ppermute`` and ``all-to-all``; within JAX's
  ``_verify_op`` tolerance (1e-5 in float32, else 5e-2) for
  ``allreduce`` and ``rs-ag``, whose sum order is the library's.
- ``bus_factor``, ``SweepConfig`` (fields, defaults, ``sizes()``), the
  verification input and every refusal of ``run_sweep`` equal JAX's.
- ``run_sweep`` on the ranks: every op verifies in both dtypes (3
  ranks), and the rows pass the JAX row schema with JAX's identity
  fields (4 ranks); a broken body fails its verification.
- The command line: rows, refusals, a launcher's group.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_coll_cases as cases
from test_torch_collectives import JDTYPES, host, run_world
from tpu_comm.analysis.rowschema import validate_row
from tpu_comm.bench import SWEEP_OPS as JSWEEP_OPS
from tpu_comm.bench import sweep as jsweep
from tpu_comm.topo import make_cart_mesh as jmake_cart_mesh
from tpu_comm_torch import cli
from tpu_comm_torch.bench import SWEEP_OPS
from tpu_comm_torch.bench import sweep as psweep
from tpu_comm_torch.bench.timing import emit_jsonl
from tpu_comm_torch.comm import collectives as pcoll
from tpu_comm_torch.comm import launch
from torch_fake_clock import PER_ITER_S, fake_clock

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (4, 3, 1)
DTYPES = ("float32", "bfloat16")
#: (op, wire dtype, accumulation dtype): every op, and the mixed ring
OPS = [(op, None, None) for op in SWEEP_OPS] + [
    ("allreduce-ring", "bfloat16", "float32")]
BODIES = [(o, dtype) for o in OPS for dtype in DTYPES]
#: the ops whose sum order the library picks
LIBRARY_ORDER = ("allreduce", "rs-ag")
#: a small sweep on the ranks: one size, a short loop
SMALL = dict(backend="cpu", min_bytes=1024, max_bytes=1024, iters=2,
             warmup=0, reps=1)
#: the rows' identity fields (as the JAX package's rows name them)
IDENTITY = ("workload", "platform", "mesh", "topo_plan", "dtype",
            "wire_dtype", "acc_dtype", "size", "iters", "verified")


def _op_id(o):
    op, wire, acc = o
    return op if wire is None else f"{op}-{wire}-wire-{acc}-acc"


def _todo(n: int) -> dict:
    todo = {}
    for seed, (o, dtype) in enumerate(BODIES):
        op, wire, acc = o
        todo["body", o, dtype] = ("body", {
            "host": host(n, 200 + seed), "op": op, "dtype": dtype,
            "wire_dtype": wire, "acc_dtype": acc})
    if n == 3:
        for o, dtype in BODIES:
            op, wire, acc = o
            todo["sweep", o, dtype] = ("sweep", {
                "op": op, "dtype": dtype, "wire_dtype": wire,
                "acc_dtype": acc, **SMALL})
    if n == 4:
        for o in (OPS[0], OPS[-1]):
            op, wire, acc = o
            todo["rows", o] = ("sweep", {
                **SMALL, "op": op, "wire_dtype": wire, "acc_dtype": acc,
                "dtype": "float32" if wire is None else "bfloat16",
                "max_bytes": 4096})
    return todo


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def world(request):
    n = request.param
    return n, run_world(n, _todo(n))


def jax_sweep_body(host_f32, n, op, dtype, wire, acc):
    """JAX's ``_sweep_jit`` at ``iters=1`` over n cpu-sim devices."""
    cart = jmake_cart_mesh(1, backend="cpu-sim", n_devices=n, periodic=True)
    (axis,) = cart.axis_names
    x = jax.device_put(jnp.asarray(host_f32).astype(JDTYPES[dtype]),
                       NamedSharding(cart.mesh, P(axis)))
    out = jsweep._sweep_jit(x, cart, op, 1, wire, acc)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("o,dtype", BODIES,
                         ids=[f"{_op_id(o)}-{d}" for o, d in BODIES])
def test_sweep_body_equals_jax(world, o, dtype):
    n, results = world
    op, wire, acc = o
    got = np.concatenate(results["body", o, dtype])
    want = jax_sweep_body(host(n, 200 + BODIES.index((o, dtype))), n, op,
                          dtype, wire, acc)
    assert got.shape == want.shape and got.dtype == np.float32
    if op in LIBRARY_ORDER:
        t = 1e-5 if dtype == "float32" else 5e-2
        np.testing.assert_allclose(got, want, atol=t, rtol=t)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", [3], indirect=True,
                         ids=lambda n: f"world{n}")
@pytest.mark.parametrize("o,dtype", BODIES,
                         ids=[f"{_op_id(o)}-{d}" for o, d in BODIES])
def test_every_op_verifies_on_3_ranks(world, o, dtype):
    _, results = world
    rows = results["sweep", o, dtype]
    assert rows[1:] == [None, None]  # rank 0 alone returns the rows
    (row,) = rows[0]
    assert row["verified"] is True and row["mesh"] == [3]
    assert (row["workload"], row["dtype"], row["wire_dtype"]) == (
        f"sweep-{o[0]}", dtype, o[1])


@pytest.mark.parametrize("world", [4], indirect=True,
                         ids=lambda n: f"world{n}")
@pytest.mark.parametrize("o", [OPS[0], OPS[-1]], ids=_op_id)
def test_rows_on_4_ranks_pass_the_schema_with_jax_identity(world, o):
    _, results = world
    op, wire, acc = o
    dtype = "float32" if wire is None else "bfloat16"
    rows = results["rows", o][0]
    jrows = jsweep.run_sweep(jsweep.SweepConfig(
        op=op, backend="cpu-sim", n_devices=4, dtype=dtype, wire_dtype=wire,
        acc_dtype=acc, min_bytes=1024, max_bytes=4096, iters=2, warmup=0,
        reps=1))
    assert len(rows) == len(jrows) == 2
    for row, jrow in zip(rows, jrows):
        errors, warnings = validate_row(json.loads(emit_jsonl(row)))
        assert errors == [] and warnings == []
        assert {k: row[k] for k in IDENTITY} == {k: jrow[k] for k in IDENTITY}
        assert row["backend"] == "cpu" and set(jrow) <= set(row)
        # the ranks time on the fake clock (``torch_fake_clock``)
        assert row["below_timing_resolution"] is False
        assert row["secs_per_iter"] == PER_ITER_S
        assert row["gbps_alg"] == row["size"] / PER_ITER_S / 1e9
        assert row["gbps_bus"] == pytest.approx(
            jsweep.bus_factor(op, 4) * row["gbps_alg"])


def test_verification_fails_on_a_wrong_body(monkeypatch):
    """A body that drops the data fails ``_verify_op`` with JAX's
    message, and no row is returned."""
    monkeypatch.setattr(pcoll, "ppermute", lambda x, perm, group=None:
                        x * 0)
    with pytest.raises(AssertionError,
                       match="sweep op ppermute verification failed"):
        psweep.run_sweep(psweep.SweepConfig(op="ppermute", **SMALL))


@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("op", list(SWEEP_OPS) + ["bogus"])
def test_bus_factor_equals_jax(op, n):
    try:
        want = jsweep.bus_factor(op, n)
    except ValueError as e:
        with pytest.raises(ValueError) as port:
            psweep.bus_factor(op, n)
        assert str(port.value) == str(e)
        return
    assert psweep.bus_factor(op, n) == want


def test_ops_and_config_equal_jax():
    assert SWEEP_OPS == JSWEEP_OPS
    port = {f.name: f.default for f in dataclasses.fields(psweep.SweepConfig)}
    jax_ = {f.name: f.default for f in dataclasses.fields(jsweep.SweepConfig)}
    # the port runs on the card unless asked for the CPU, and bounds a
    # run of many ranks in time
    assert (port.pop("backend"), jax_.pop("backend")) == ("cuda", "auto")
    assert port.pop("dist_timeout") == 600.0
    assert port == jax_


@pytest.mark.parametrize("lo,hi", [(1 << 10, 1 << 26), (1 << 10, 1 << 30),
                                   (1000, 5000), (7, 7), (4096, 1 << 20)])
def test_sizes_equal_jax(lo, hi):
    assert (psweep.SweepConfig(min_bytes=lo, max_bytes=hi).sizes()
            == jsweep.SweepConfig(min_bytes=lo, max_bytes=hi).sizes())


@pytest.mark.parametrize("n", [1, 3, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_verification_input_equals_jax(dtype, n):
    """JAX draws the input of ``_verify_op`` with ``ml_dtypes``; the port
    narrows the same draw with torch."""
    per_dev = ((max(n, 8) + n - 1) // n) * n
    want = np.random.default_rng(0).standard_normal(
        (n * per_dev,)).astype(np.dtype(dtype)).astype(np.float32)
    got = psweep.sweep_input(np.random.default_rng(0), n * per_dev, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


REFUSALS = [
    dict(op="bogus"),
    dict(op="bogus", min_bytes=0),
    dict(min_bytes=0),
    dict(min_bytes=4096, max_bytes=1024),
    dict(min_bytes=4096, max_bytes=1024, wire_dtype="bfloat16"),
    dict(op="allreduce", wire_dtype="bfloat16"),
    dict(op="rs-ag", acc_dtype="float32"),
    dict(op="bcast-tree", wire_dtype="float16", acc_dtype="float32"),
]


@pytest.mark.parametrize("kw", REFUSALS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_refusals_equal_jax(kw):
    with pytest.raises(ValueError) as jax_err:
        jsweep.run_sweep(jsweep.SweepConfig(backend="cpu-sim", **kw))
    with pytest.raises(ValueError) as port:
        psweep.run_sweep(psweep.SweepConfig(backend="cpu", **kw))
    assert str(port.value) == str(jax_err.value)


def _run_cli(*argv, env=None, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "tpu_comm_torch", *argv], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout, env=env,
    )


def test_cli_sweep_on_4_ranks_prints_a_row_a_size(tmp_path):
    res = _run_cli("sweep", "--backend", "cpu", "--n-devices", "4", "--op",
                   "allreduce", "--min-bytes", "1024", "--max-bytes", "4096",
                   "--iters", "3", "--jsonl", str(tmp_path / "rows.jsonl"))
    assert res.returncode == 0, res.stderr
    rows = [json.loads(line) for line in res.stdout.strip().splitlines()]
    assert [r["size"] for r in rows] == [1024, 4096]
    banked = [json.loads(line) for line in
              (tmp_path / "rows.jsonl").read_text().splitlines()]
    for row, bank in zip(rows, banked):
        assert (row["workload"], row["mesh"], row["verified"],
                row["platform"]) == ("sweep-allreduce", [4], True, "cpu")
        assert validate_row(bank) == ([], [])
        assert {k: bank[k] for k in IDENTITY} == {k: row[k] for k in IDENTITY}


def test_cli_sweep_defaults_to_the_card_and_refuses_without_one(capsys):
    assert cli.main(["sweep", "--max-bytes", "1024"]) == 2
    assert "no CUDA device is available" in capsys.readouterr().err


@pytest.mark.parametrize("argv,message", [
    (["--op", "allreduce", "--wire-dtype", "bfloat16"],
     "only apply to the explicit ring"),
    (["--min-bytes", "0"], "need 0 < min_bytes <= max_bytes"),
    (["--n-devices", "0"], "--n-devices must be >= 1"),
])
def test_cli_sweep_refuses_bad_runs(capsys, argv, message):
    assert cli.main(["sweep", "--backend", "cpu", *argv]) == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("flag", [
    ["--op", "reduce-scatter"], ["--trace", "out.json"],
    ["--deadline", "5"], ["--backend", "cpu-sim"], ["--wire-dtype", "int8"],
])
def test_cli_sweep_refuses_flags_and_names_it_does_not_have(flag):
    with pytest.raises(SystemExit) as e:
        cli.main(["sweep", *flag])
    assert e.value.code == 2


def test_cli_sweep_joins_the_group_a_launcher_gives_it():
    """With RANK and WORLD_SIZE set (as ``torchrun`` sets them) each
    process is one rank; rank 0 alone prints the rows."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "tpu_comm_torch", "sweep", "--backend",
            "cpu", "--op", "bcast-tree", "--max-bytes", "1024", "--iters",
            "2", "--dist-timeout", "90"]
    procs = [
        subprocess.Popen(
            argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
            env={**os.environ, "RANK": str(rank), "WORLD_SIZE": "2",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                 "OMP_NUM_THREADS": "1"},
        )
        for rank in range(2)
    ]
    try:
        outs = [p.communicate(timeout=150) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    (row,) = [json.loads(line) for line in outs[0][0].splitlines()]
    assert (row["mesh"], row["workload"], row["verified"]) == (
        [2], "sweep-bcast-tree", True)
    assert outs[1][0].strip() == ""


def test_cli_sweep_refuses_a_world_the_launcher_did_not_start(capsys,
                                                            monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert cli.main(["sweep", "--backend", "cpu", "--n-devices", "3"]) == 2
    assert "--n-devices 3 needs 3 ranks, the launcher started 2" in (
        capsys.readouterr().err)


@pytest.mark.parametrize("lost,want_iters,calls", [
    (1, 4 * SMALL["iters"], 2),
    (psweep.SLOPE_RETRIES + 1, 16 * SMALL["iters"], 3),
])
def test_a_lost_slope_is_timed_again_with_a_longer_loop(lost, want_iters,
                                                        calls):
    """The first ``lost`` timings of a row see no slope (the clock moves
    only by its reads); each is timed again with a loop 4x longer, up to
    SLOPE_RETRIES times. A row resolved on a retry carries that loop's
    length and exact rates; one never resolved says so, with null rates,
    as JAX's."""
    seen = []
    with fake_clock(per_iter_s=0.0) as clock:
        timed = psweep.time_loop_per_iter

        def scripted(run_iters, iters, *args, **kwargs):
            seen.append(iters)
            if len(seen) > lost:
                clock.per_iter_s = PER_ITER_S
            return timed(run_iters, iters, *args, **kwargs)

        psweep.time_loop_per_iter = scripted
        try:
            (row,) = psweep.run_sweep(psweep.SweepConfig(op="allreduce",
                                                         **SMALL))
        finally:
            psweep.time_loop_per_iter = timed
    assert seen == [SMALL["iters"] * 4 ** i for i in range(calls)]
    assert row["iters"] == want_iters
    if lost > psweep.SLOPE_RETRIES:
        assert row["below_timing_resolution"] is True
        assert (row["secs_per_iter"], row["gbps_alg"]) == (0.0, None)
    else:
        assert row["below_timing_resolution"] is False
        assert row["secs_per_iter"] == PER_ITER_S
        assert row["gbps_alg"] == row["size"] / PER_ITER_S / 1e9


def test_launcher_world_of_one_in_process_is_a_group_of_one():
    """A world of one builds its own group and leaves none behind."""
    import torch.distributed as dist

    with fake_clock():
        rows = psweep.run_sweep(psweep.SweepConfig(op="all-to-all",
                                                   **SMALL))
    assert [r["mesh"] for r in rows] == [[1]]
    assert rows[0]["gbps_bus"] == 0.0
    assert not dist.is_initialized()
    assert launch.backend_for("cpu") == "gloo"
