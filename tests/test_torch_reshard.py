"""The port's reshard family (``tpu_comm_torch/comm/reshard.py``,
``tpu_comm_torch/bench/reshard.py`` and the ``reshard`` subcommand) held
against the JAX package's, on the CPU.

- The plan tables and the traffic model equal JAX's for every mesh pair
  of JAX's grid (``tests/test_reshard.py``: 1D<->2D, an asymmetric
  transpose, a world that is not a power of two, shrink-by-one) and for
  the card's meshes of one: every step's ``k``, ``slab``,
  ``send_start``, ``dst_start``, ``ext``, the pads, ``max_slab``,
  ``moved_bytes`` and per arm ``wire_bytes_per_chip``,
  ``peak_live_bytes`` and ``n_steps``; the validation errors are JAX's;
  the NumPy executor equals the oracle.
- Both device arms on ``gloo`` ranks, one spawn a world size (4, 6, 8;
  every pair of that union world in it, ``torch_reshard_cases``), in
  float32, bfloat16 and float16: every rank's output bitwise equal to
  the oracle and to JAX's ``build_reshard_fn`` on a cpu-sim mesh of the
  union world, on the same position-coded input (``_host_field``, equal
  to JAX's bit for bit).
- ``run_reshard_bench`` on the ranks (fake clock) and the command line:
  rows that pass the JAX row schema, with JAX's identity and model
  fields; the refusals.
"""

import dataclasses
import functools
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_reshard_cases as cases
from tpu_comm.analysis.rowschema import validate_row
from tpu_comm.bench import RESHARD_IMPLS as JRESHARD_IMPLS
from tpu_comm.bench import reshard as jbench
from tpu_comm.comm import reshard as jrs
from tpu_comm.topo import make_cart_mesh as jmake_cart_mesh
from tpu_comm_torch import cli
from tpu_comm_torch.bench import RESHARD_IMPLS
from tpu_comm_torch.bench import reshard as pbench
from tpu_comm_torch.bench.sweep import SLOPE_RETRIES
from tpu_comm_torch.bench.timing import emit_jsonl
from tpu_comm_torch.comm import launch
from tpu_comm_torch.comm import reshard as prs
from tpu_comm_torch.kernels.tiling import DTYPES as TDTYPES
from torch_fake_clock import PER_ITER_S, fake_clock

ROOT = Path(__file__).resolve().parents[1]
#: JAX's acceptance grid (tests/test_reshard.py)
MESH_PAIRS = [
    ((4, 1), (2, 2)),   # 1D -> 2D
    ((2, 2), (4, 1)),   # 2D -> 1D
    ((4, 2), (2, 4)),   # asymmetric transpose (8 ranks)
    ((3, 2), (6, 1)),   # non-power-of-two world
    ((4, 1), (3, 1)),   # shrink-by-one (rank-loss recovery shape)
]
#: the card's meshes of one (world size 1: the arms move nothing)
ONE = [((1,), (1,)), ((1, 1), (1, 1)), ((1, 1, 1), (1, 1, 1))]
#: the plan-only extras: a 3-axis pair, growth
PLAN_PAIRS = MESH_PAIRS + ONE + [((2, 2, 1), (1, 2, 2)), ((2, 1), (5, 1))]
DTYPES = ("float32", "bfloat16", "float16")
JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "float16": jnp.float16}


def _id(pair):
    s, d = pair
    return "x".join(map(str, s)) + "->" + "x".join(map(str, d))


def _gshape(src, dst):
    return tuple(math.lcm(s, d) * 3 for s, d in zip(src, dst))


def _n_world(pair):
    return max(math.prod(pair[0]), math.prod(pair[1]))


# ------------------------------------------------------- plan + model

@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("pair", PLAN_PAIRS, ids=_id)
def test_plan_tables_and_model_equal_jax(pair, itemsize):
    src, dst = pair
    gshape = _gshape(src, dst)
    want = jrs.plan_reshard(gshape, src, dst, itemsize)
    got = prs.plan_reshard(gshape, src, dst, itemsize)
    assert (got.n_src, got.n_dst, got.n_world) == (
        want.n_src, want.n_dst, want.n_world)
    assert (got.src_local, got.dst_local) == (want.src_local, want.dst_local)
    assert len(got.steps) == len(want.steps)
    for a, b in zip(got.steps, want.steps):
        assert (a.k, a.slab) == (b.k, b.slab)
        for table in ("send_start", "dst_start", "ext"):
            x, y = getattr(a, table), getattr(b, table)
            assert x.dtype == y.dtype and np.array_equal(x, y), table
    assert (got.src_pad, got.dst_pad, got.max_slab) == (
        want.src_pad, want.dst_pad, want.max_slab)
    assert got.moved_bytes == want.moved_bytes
    for arm in prs.ARMS:
        assert got.wire_bytes_per_chip(arm) == want.wire_bytes_per_chip(arm)
        assert got.peak_live_bytes(arm) == want.peak_live_bytes(arm)
        assert got.n_steps(arm) == want.n_steps(arm)
    for r in range(got.n_dst):
        assert got._off(r, dst, got.dst_local) == want._off(
            r, dst, want.dst_local)


BAD_PLANS = [
    ((10, 10), (4, 1), (2, 2), 4),
    ((8, 8), (4,), (2, 2), 4),
    ((), (), (), 4),
    ((8, 8), (0, 1), (2, 2), 4),
    ((8, 8), (4, 1), (2, -2), 4),
    ((8, 8), (4, 1), (2, 2), 0),
]


@pytest.mark.parametrize("args", BAD_PLANS, ids=lambda a: repr(a))
def test_plan_validation_errors_equal_jax(args):
    with pytest.raises(ValueError) as want:
        jrs.plan_reshard(*args)
    with pytest.raises(ValueError) as got:
        prs.plan_reshard(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("method", ["wire_bytes_per_chip",
                                    "peak_live_bytes", "n_steps"])
def test_unknown_arm_errors_equal_jax(method):
    with pytest.raises(ValueError) as want:
        getattr(jrs.plan_reshard((8, 8), (4, 1), (2, 2), 4), method)("x")
    with pytest.raises(ValueError) as got:
        getattr(prs.plan_reshard((8, 8), (4, 1), (2, 2), 4), method)("x")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("pair", PLAN_PAIRS, ids=_id)
def test_numpy_executor_equals_oracle_and_jax(pair):
    src, dst = pair
    gshape = _gshape(src, dst)
    g = np.arange(math.prod(gshape), dtype=np.float32).reshape(gshape)
    plan = prs.plan_reshard(gshape, src, dst, g.itemsize)
    got = prs.apply_plan_numpy(plan, prs.split_blocks(g, src))
    want = prs.oracle_blocks(g, dst)
    jwant = jrs.apply_plan_numpy(
        jrs.plan_reshard(gshape, src, dst, g.itemsize),
        jrs.split_blocks(g, src))
    assert len(got) == len(want) == len(jwant) == plan.n_dst
    for a, b, c in zip(got, want, jwant):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert np.array_equal(prs.assemble(want, dst, gshape), g)
    stack = prs.stack_blocks(g, src, plan.n_world)
    assert np.array_equal(stack, jrs.stack_blocks(g, src, plan.n_world))
    assert prs._interleave_perm(len(src)) == jrs._interleave_perm(len(src))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gshape", [(4096,), (96, 64), (8, 16, 24)])
def test_host_field_bits_equal_jax(gshape, dtype):
    """The position-coded field equals JAX's bit for bit (bfloat16
    rounds the indices past 256 the same way)."""
    got = pbench._bits(pbench._host_field(gshape, TDTYPES[dtype]))
    want = jbench._host_field(gshape, JDTYPES[dtype])
    assert np.array_equal(got, want.view(got.dtype))


# -------------------------------------------------- the arms on ranks

def _pairs_of(n):
    return [p for p in MESH_PAIRS + ONE if _n_world(p) == n]


#: ``run_reshard_bench`` on the ranks of a world of 4: a config each
BENCH_CONFIGS = [
    dict(src_mesh=(4, 1), dst_mesh=(2, 2), size=16),
    dict(src_mesh=(4, 1), dst_mesh=(3, 1), size=12, dtype="bfloat16",
         impl="sequential"),
    dict(src_mesh=(2, 2), dst_mesh=(4, 1), size=8, dtype="float16",
         impl="naive"),
]
SMALL = dict(backend="cpu", iters=2, warmup=0, reps=1)


def _todo(n):
    todo = {(pair, arm, dtype): ("reshard", {
        "src": pair[0], "dst": pair[1], "gshape": _gshape(*pair),
        "arm": arm, "dtype": dtype})
        for pair in _pairs_of(n) for arm in prs.ARMS for dtype in DTYPES}
    if n == 4:
        for i, cfg in enumerate(BENCH_CONFIGS):
            todo["bench", i] = ("reshard_bench", {**cfg, **SMALL})
    return todo


def run_world(n, todo):
    if n == 1:
        with launch.process_group("gloo", timeout_s=120):
            return cases.run_cases(todo)
    with pytest.MonkeyPatch.context() as env:
        env.setenv("OMP_NUM_THREADS", "1")
        return launch.run_ranks(cases.run_cases, n, "gloo", (todo,),
                                timeout_s=300)


@functools.cache
def world(n):
    """Every case of the union world ``n``, from one spawn of n ranks."""
    return run_world(n, _todo(n))


def jax_arm(pair, arm, dtype):
    """JAX's ``build_reshard_fn`` on a cpu-sim mesh of the union world,
    on JAX's ``_host_field``: ``(n_world, *dst_local)`` bit patterns."""
    src, dst = pair
    gshape = _gshape(src, dst)
    g = jbench._host_field(gshape, JDTYPES[dtype])
    plan = jrs.plan_reshard(gshape, src, dst, g.itemsize)
    cart = jmake_cart_mesh(1, backend="cpu-sim", shape=(plan.n_world,),
                           axis_names=("r",))
    x = jax.device_put(jrs.stack_blocks(g, src, plan.n_world),
                       NamedSharding(cart.mesh, P("r")))
    out = np.asarray(jax.jit(jrs.build_reshard_fn(plan, arm, cart))(x))
    bits = np.dtype(f"i{g.itemsize}")
    return out.view(bits), [b.view(bits) for b in jrs.oracle_blocks(g, dst)]


ARM_CASES = [(_n_world(p), p, arm, dtype) for p in MESH_PAIRS + ONE
             for arm in prs.ARMS for dtype in DTYPES]


@pytest.mark.parametrize(
    "n,pair,arm,dtype", ARM_CASES,
    ids=[f"{_id(p)}-{a}-{d}" for _, p, a, d in ARM_CASES])
def test_arm_on_ranks_bitwise_equals_oracle_and_jax(n, pair, arm, dtype):
    got = world(n)[pair, arm, dtype]
    jout, want = jax_arm(pair, arm, dtype)
    plan = prs.plan_reshard(_gshape(*pair), pair[0], pair[1], 4)
    assert len(got) == plan.n_world
    for d in range(plan.n_dst):
        assert got[d].dtype == want[d].dtype
        assert np.array_equal(got[d], want[d]), (arm, d)
        assert np.array_equal(got[d], jout[d]), (arm, d)


# -------------------------------------------------------- the driver

#: the rows' identity and model fields (as the JAX package's rows name
#: them)
IDENTITY = ("workload", "impl", "src_mesh", "dst_mesh", "dtype", "size",
            "iters", "verified", "moved_bytes", "wire_bytes_per_chip",
            "peak_live_bytes", "reshard_steps")


def jax_rows(cfg: dict) -> list:
    return jbench.run_reshard_bench(jbench.ReshardConfig(
        **{**cfg, **SMALL, "backend": "cpu-sim"}))


@pytest.mark.parametrize("i", range(len(BENCH_CONFIGS)))
def test_bench_rows_on_4_ranks_pass_the_schema_with_jax_fields(i):
    cfg = BENCH_CONFIGS[i]
    rows = world(4)["bench", i][0]
    jrows = jax_rows(cfg)
    assert [r["impl"] for r in rows] == [r["impl"] for r in jrows]
    plan_rev = prs.plan_reshard(
        rows[0]["size"], cfg["dst_mesh"], cfg["src_mesh"],
        TDTYPES[cfg.get("dtype", "float32")].itemsize)
    for row, jrow in zip(rows, jrows):
        errors, warnings = validate_row(json.loads(emit_jsonl(row)))
        assert errors == [] and warnings == []
        assert {k: row[k] for k in IDENTITY} == {k: jrow[k] for k in IDENTITY}
        assert set(jrow) - {"peak_live_bytes_xla"} <= set(row)
        assert (row["backend"], row["platform"], row["dispatch"]) == (
            "cpu", "cpu", "eager")
        # measured on the card only
        assert "peak_live_bytes_measured" not in row
        # the ranks time on the fake clock (``torch_fake_clock``)
        assert row["secs_per_iter"] == PER_ITER_S
        assert row["secs_per_reshard"] == PER_ITER_S / 2
        wire_rt = row["wire_bytes_per_chip"] + plan_rev.wire_bytes_per_chip(
            row["impl"])
        assert row["gbps_eff"] == wire_rt / PER_ITER_S / 1e9
        assert row["below_timing_resolution"] is False


def test_bench_at_world_size_1_in_process_moves_nothing():
    with launch.process_group("gloo", timeout_s=120):
        rows = pbench.run_reshard_bench(pbench.ReshardConfig(
            src_mesh=(1, 1), dst_mesh=(1, 1), size=8, **SMALL))
    for row in rows:
        assert row["verified"] and row["moved_bytes"] == 0
        assert row["wire_bytes_per_chip"] == 0 and row["gbps_eff"] is None


@pytest.mark.parametrize("lost,want_iters,calls", [
    (1, 4 * SMALL["iters"], 2),
    (SLOPE_RETRIES + 1, 16 * SMALL["iters"], 3),
])
def test_a_lost_slope_is_timed_again_with_a_longer_loop(lost, want_iters,
                                                        calls):
    """The first ``lost`` timings of an arm see no slope (the clock moves
    only by its reads); each is timed again with a loop 4x longer, up to
    SLOPE_RETRIES times, as the sweep does. A row resolved on a retry
    carries that loop's length and exact time; one never resolved says
    so, with a null rate, as JAX's."""
    seen = []
    with fake_clock(per_iter_s=0.0) as clock:
        timed = pbench.time_loop_per_iter

        def scripted(run_iters, iters, *args, **kwargs):
            seen.append(iters)
            if len(seen) > lost:
                clock.per_iter_s = PER_ITER_S
            return timed(run_iters, iters, *args, **kwargs)

        pbench.time_loop_per_iter = scripted
        try:
            with launch.process_group("gloo", timeout_s=120):
                (row,) = pbench.run_reshard_bench(pbench.ReshardConfig(
                    src_mesh=(1,), dst_mesh=(1,), size=64,
                    **{**SMALL, "impl": "naive"}))
        finally:
            pbench.time_loop_per_iter = timed
    assert seen == [SMALL["iters"] * 4 ** i for i in range(calls)]
    assert row["iters"] == want_iters
    if lost > SLOPE_RETRIES:
        assert row["below_timing_resolution"] is True
        assert (row["secs_per_reshard"], row["gbps_eff"]) == (0.0, None)
    else:
        assert row["below_timing_resolution"] is False
        assert row["secs_per_reshard"] == PER_ITER_S / 2


def test_verification_fails_on_a_wrong_arm(monkeypatch):
    monkeypatch.setattr(prs, "reshard_block",
                        lambda u, plan, arm, group=None: u * 0 + 1)
    with pytest.raises(AssertionError,
                       match=r"reshard verification FAILED \(naive\)"):
        pbench.run_reshard_bench(pbench.ReshardConfig(
            src_mesh=(1,), dst_mesh=(1,), size=64, **SMALL))


def test_impls_and_config_equal_jax():
    assert RESHARD_IMPLS == JRESHARD_IMPLS == pbench.IMPL_CHOICES
    assert pbench.IMPL_CHOICES == (*prs.ARMS, "both") == jbench.IMPL_CHOICES
    assert pbench.RESHARD_DEFAULT_SIZE == jbench.RESHARD_DEFAULT_SIZE
    port = {f.name: f.default
            for f in dataclasses.fields(pbench.ReshardConfig)}
    jax_ = {f.name: f.default
            for f in dataclasses.fields(jbench.ReshardConfig)}
    # the port runs on the card unless asked for the CPU
    assert (port.pop("backend"), jax_.pop("backend")) == ("cuda", "auto")
    assert port == jax_
    for mesh in [(4, 1), (8,), (2, 2, 2)]:
        assert (pbench.ReshardConfig(src_mesh=mesh).global_shape
                == jbench.ReshardConfig(src_mesh=mesh).global_shape)


REFUSALS = [
    dict(impl="bogus"),
    dict(src_mesh=(4,), dst_mesh=(2, 2)),
    dict(size=10),
    dict(src_mesh=(1, 1, 1, 1), dst_mesh=(1, 1, 1, 1)),
    dict(src_mesh=(3, 1), dst_mesh=(2, 2), size=9),
]


@pytest.mark.parametrize("kw", REFUSALS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_refusals_equal_jax(kw):
    with pytest.raises(ValueError) as jax_err:
        jbench.run_reshard_bench(jbench.ReshardConfig(backend="cpu-sim",
                                                      **kw))
    with pytest.raises(ValueError) as port:
        pbench.run_reshard_bench(pbench.ReshardConfig(backend="cpu", **kw))
    assert str(port.value) == str(jax_err.value)


def test_refuses_a_bad_dtype():
    with pytest.raises(ValueError, match="dtype must be one of"):
        pbench.run_reshard_bench(pbench.ReshardConfig(backend="cpu",
                                                      dtype="int8"))


def test_refuses_a_union_world_larger_than_the_card_count(monkeypatch):
    """On the card every rank needs a GPU of its own: refused before a
    rank starts, naming both numbers."""
    import tpu_comm_torch.topo as topo

    monkeypatch.setattr(topo, "get_device",
                        lambda backend: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError,
                       match="union world of 4 ranks.* there are 1"):
        pbench.run_reshard_bench(pbench.ReshardConfig())


def _run_cli(*argv, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "tpu_comm_torch", *argv], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout,
    )


def test_cli_reshard_on_4_ranks_prints_both_arms(tmp_path):
    argv = ["--src-mesh", "4,1", "--dst-mesh", "2,2", "--size", "64",
            "--iters", "2", "--warmup", "0", "--reps", "1"]
    res = _run_cli("reshard", "--backend", "cpu", *argv, "--jsonl",
                   str(tmp_path / "rows.jsonl"))
    assert res.returncode == 0, res.stderr
    rows = [json.loads(line) for line in res.stdout.strip().splitlines()]
    banked = [json.loads(line) for line in
              (tmp_path / "rows.jsonl").read_text().splitlines()]
    jrows = jax_rows(dict(src_mesh=(4, 1), dst_mesh=(2, 2), size=64))
    assert [r["impl"] for r in rows] == ["naive", "sequential"]
    for row, bank, jrow in zip(rows, banked, jrows):
        assert validate_row(bank) == ([], [])
        assert {k: row[k] for k in IDENTITY} == {k: jrow[k] for k in IDENTITY}
        assert {k: bank[k] for k in IDENTITY} == {k: row[k] for k in IDENTITY}
        assert (row["platform"], row["dispatch"]) == ("cpu", "eager")
    naive, seq = rows
    assert seq["peak_live_bytes"] < naive["peak_live_bytes"]
    assert naive["reshard_steps"] == 1 and seq["reshard_steps"] > 1


def test_cli_reshard_defaults_to_the_card_and_refuses_without_one(capsys):
    assert cli.main(["reshard", "--src-mesh", "1", "--dst-mesh", "1"]) == 2
    assert "no CUDA device is available" in capsys.readouterr().err


@pytest.mark.parametrize("argv,message", [
    (["--src-mesh", "4,1", "--dst-mesh", "2,2", "--size", "10"],
     "not divisible"),
    (["--src-mesh", "4", "--dst-mesh", "2,2", "--size", "16"],
     "same number of axes"),
    (["--src-mesh", "4,x", "--dst-mesh", "2,2"],
     "--src-mesh must be a comma list of integers"),
    (["--src-mesh", "", "--dst-mesh", "2,2"], "must be non-empty"),
])
def test_cli_reshard_refuses_bad_configs(capsys, argv, message):
    assert cli.main(["reshard", "--backend", "cpu", *argv]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and message in err


@pytest.mark.parametrize("flag", [
    ["--impl", "pallas"], ["--trace", "out.json"], ["--deadline", "5"],
    ["--backend", "cpu-sim"], ["--dtype", "int8"],
])
def test_cli_reshard_refuses_flags_and_names_it_does_not_have(flag):
    with pytest.raises(SystemExit) as e:
        cli.main(["reshard", "--src-mesh", "1", "--dst-mesh", "1", *flag])
    assert e.value.code == 2
