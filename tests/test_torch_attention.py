"""The port's ring and Ulysses attention
(``tpu_comm_torch/extras/ring_attention.py``), its bench
(``tpu_comm_torch/bench/attention.py``) and the ``attention``
subcommand, held against the JAX package's on the CPU.

- ``run_ring_attention`` on 8 ``gloo`` ranks (one spawn for the file,
  ``torch_reshard_cases``) against JAX's on a cpu-sim mesh of 8, at the
  shapes of ``tests/test_ring_attention.py`` (ring: seq 64, d 16;
  Ulysses: seq 64, 8 heads, d 8), causal and not, on the same seeded
  inputs: within JAX's own bound against the dense golden (2e-5) in
  float32, 2e-2 in bfloat16; ring (heads batched through one ring)
  equals Ulysses; Ulysses refuses heads the ranks do not divide.
- ``run_attention_bench`` on the 8 ranks (fake clock) at JAX's test
  shapes (seq 256, 8 heads, d 16): the rows' fields equal JAX's, the
  ring's wire bytes are ``2 * 32 * 8 * 16 * itemsize * 7``, the FLOPs
  halve under causal; the refusals are JAX's, in JAX's order.
- At world size 1 (the card's), in process: both arms against the
  golden. The command line: a row, the refusals.
"""

import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_reshard import run_world
from tpu_comm.analysis.rowschema import validate_row
from tpu_comm.bench import attention as jbench
from tpu_comm.extras import ring_attention as jra
from tpu_comm.topo import make_cart_mesh as jmake_cart_mesh
from tpu_comm_torch import cli
from tpu_comm_torch.bench import attention as pbench
from tpu_comm_torch.bench.timing import emit_jsonl
from tpu_comm_torch.comm import launch
from tpu_comm_torch.extras import ring_attention as pra
from torch_fake_clock import PER_ITER_S

ROOT = Path(__file__).resolve().parents[1]
N = 8
DTYPES = ("float32", "bfloat16")
JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: impl -> the global (seq, ...) shape of tests/test_ring_attention.py
SHAPES = {"ring": (64, 16), "ulysses": (64, 8, 8)}
#: the ring with heads batched, beside Ulysses (JAX's ring_equals_ulysses)
MH_SHAPE = (32, 8, 4)
ATTN_CASES = [(impl, causal, dtype) for impl in SHAPES
              for causal in (False, True) for dtype in DTYPES]
#: run_attention_bench at JAX's test shapes, on the 8 ranks
BENCH_CASES = [(impl, causal, dtype) for impl in ("ring", "ulysses")
               for causal in (False, True) for dtype in DTYPES]
SMALL = dict(seq=256, heads=8, head_dim=16, iters=2, warmup=0, reps=1)


def qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _todo():
    todo = {}
    for seed, (impl, causal, dtype) in enumerate(ATTN_CASES):
        q, k, v = qkv(SHAPES[impl], seed)
        todo["attn", impl, causal, dtype] = ("attention", {
            "q": q, "k": k, "v": v, "impl": impl, "causal": causal,
            "dtype": dtype})
    q, k, v = qkv(MH_SHAPE, 99)
    for impl in ("ring", "ulysses"):
        for causal in (False, True):
            todo["mh", impl, causal] = ("attention", {
                "q": q, "k": k, "v": v, "impl": impl, "causal": causal,
                "dtype": "float32"})
    q, k, v = qkv((16, 6, 4), 7)
    todo["indivisible"] = ("attention", {
        "q": q, "k": k, "v": v, "impl": "ulysses", "causal": False,
        "dtype": "float32"})
    for impl, causal, dtype in BENCH_CASES:
        todo["bench", impl, causal, dtype] = ("attention_bench", {
            **SMALL, "impl": impl, "causal": causal, "dtype": dtype,
            "backend": "cpu"})
    return todo


@functools.cache
def ranks():
    """Every case of this file on 8 gloo ranks, one spawn."""
    return run_world(N, _todo())


@functools.cache
def jax_cart():
    return jmake_cart_mesh(1, backend="cpu-sim", shape=(N,), periodic=True)


def jax_attention(q, k, v, impl, causal, dtype):
    out = jra.run_ring_attention(
        jax_cart(), *(jnp.asarray(x).astype(JDTYPES[dtype])
                      for x in (q, k, v)), causal=causal, impl=impl)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("impl,causal,dtype", ATTN_CASES)
def test_attention_on_8_ranks_equals_jax(impl, causal, dtype):
    params = _todo()["attn", impl, causal, dtype][1]
    got = ranks()["attn", impl, causal, dtype][0]
    want = jax_attention(params["q"], params["k"], params["v"], impl,
                         causal, dtype)
    assert got.shape == want.shape == SHAPES[impl]
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    if dtype == "float32":
        golden = pra.reference_attention(params["q"], params["k"],
                                         params["v"], causal=causal)
        np.testing.assert_allclose(got, golden, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_equals_ulysses(causal):
    """The two strategies are exact, so they agree with each other and
    with the golden; the multi-head ring (heads batched through one ring,
    the JAX bench's vmap) runs on (block, heads, d) blocks."""
    res = ranks()
    ring, uly = res["mh", "ring", causal][0], res["mh", "ulysses", causal][0]
    np.testing.assert_allclose(ring, uly, atol=2e-5, rtol=2e-5)
    q, k, v = qkv(MH_SHAPE, 99)
    np.testing.assert_allclose(
        ring, pra.reference_attention(q, k, v, causal=causal),
        atol=2e-5, rtol=2e-5)
    if not causal:
        np.testing.assert_allclose(
            uly, jax_attention(q, k, v, "ulysses", False, "float32"),
            atol=2e-5, rtol=2e-5)


def test_ulysses_head_divisibility():
    errors = ranks()["indivisible"]
    assert all(isinstance(e, ValueError) for e in errors)
    q = k = v = np.zeros((16, 6, 4), np.float32)
    with pytest.raises(ValueError) as want:
        jra.run_ring_attention(jax_cart(), q, k, v, impl="ulysses")
    assert str(errors[0]) == str(want.value) == \
        "heads 6 not divisible by axis size 8"


def jax_row(impl, causal, dtype):
    return jbench.run_attention_bench(jbench.AttnConfig(
        **SMALL, impl=impl, causal=causal, dtype=dtype, backend="cpu-sim",
        n_devices=N))


IDENTITY = ("workload", "mesh", "dtype", "causal", "size", "iters",
            "verified", "ring_bytes_per_chip_per_iter")


@pytest.mark.parametrize("impl,causal,dtype", BENCH_CASES)
def test_bench_rows_on_8_ranks_equal_jax(impl, causal, dtype):
    row = ranks()["bench", impl, causal, dtype][0]
    jrow = jax_row(impl, causal, dtype)
    errors, warnings = validate_row(json.loads(emit_jsonl(row)))
    assert errors == [] and warnings == []
    assert {k: row[k] for k in IDENTITY} == {k: jrow[k] for k in IDENTITY}
    assert set(jrow) <= set(row)
    assert row["workload"] == f"attention-{impl}"
    assert (row["backend"], row["platform"], row["dispatch"]) == (
        "cpu", "cpu", "eager")
    itemsize = 4 if dtype == "float32" else 2
    ring = 2 * 32 * 8 * 16 * itemsize * 7
    assert row["ring_bytes_per_chip_per_iter"] == (
        ring if impl == "ring" else None)
    # the ranks time on the fake clock (``torch_fake_clock``)
    assert row["secs_per_iter"] == PER_ITER_S
    flops = 4 * 256 * 256 * 16 * 8 / (2 if causal else 1)
    assert row["tflops"] == flops / PER_ITER_S / 1e12
    assert row["ring_gbps_per_chip"] == (
        ring / PER_ITER_S / 1e9 if impl == "ring" else None)


@pytest.mark.parametrize("causal", [False, True])
def test_attn_flops_equal_jax_and_halve_under_causal(causal):
    for seq, heads, d in [(4096, 8, 128), (256, 8, 16), (64, 1, 8)]:
        kw = dict(seq=seq, heads=heads, head_dim=d, causal=causal)
        got = pbench._attn_flops(pbench.AttnConfig(**kw))
        assert got == jbench._attn_flops(jbench.AttnConfig(**kw))
        full = pbench._attn_flops(pbench.AttnConfig(**{**kw,
                                                       "causal": False}))
        assert got == (full / 2 if causal else full)


def test_config_equals_jax():
    port = {f.name: f.default for f in dataclasses.fields(pbench.AttnConfig)}
    jax_ = {f.name: f.default for f in dataclasses.fields(jbench.AttnConfig)}
    assert (port.pop("backend"), jax_.pop("backend")) == ("cuda", "auto")
    assert port == jax_


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(48, 8), (40, 3, 8)])
def test_reference_attention_equals_jax(shape, causal):
    q, k, v = qkv(shape, 5)
    assert np.array_equal(pra.reference_attention(q, k, v, causal),
                          jra.reference_attention(q, k, v, causal))


def test_inputs_equal_jax():
    """JAX's q, k, v: default_rng(0) draws, narrowed by torch."""
    cfg = pbench.AttnConfig(seq=16, heads=2, head_dim=4, dtype="bfloat16")
    rng = np.random.default_rng(0)
    for got in pbench.attention_inputs(cfg):
        want = jnp.asarray(rng.standard_normal((16, 2, 4)).astype(
            np.float32), dtype=jnp.bfloat16).astype(jnp.float32)
        assert np.array_equal(got.float().numpy(), np.asarray(want))


REFUSALS = [
    dict(impl="bogus"),
    dict(seq=100),
    dict(heads=6),
    dict(seq=100, heads=6, dtype="float16"),
    dict(heads=12, dtype="float16"),
    dict(impl="ulysses", heads=4),
]


@pytest.mark.parametrize("kw", REFUSALS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_refusals_equal_jax(kw):
    kw = {**SMALL, **kw}
    with pytest.raises(ValueError) as jax_err:
        jbench.run_attention_bench(jbench.AttnConfig(
            backend="cpu-sim", n_devices=N, **kw))
    with pytest.raises(ValueError) as port:
        pbench.run_attention_bench(pbench.AttnConfig(
            backend="cpu", n_devices=N, **kw))
    assert str(port.value) == str(jax_err.value)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl,shape", [("ring", (24, 8)),
                                        ("ring", (24, 2, 8)),
                                        ("ulysses", (24, 2, 8))])
def test_world_of_one_equals_the_golden(impl, shape, causal):
    """The card's world size: the ring makes no hop, Ulysses' all-to-all
    moves nothing."""
    q, k, v = qkv(shape, 3)
    with launch.process_group("gloo", timeout_s=120):
        got = pra.run_ring_attention(q, k, v, causal=causal, impl=impl)
    np.testing.assert_allclose(
        got.numpy(), pra.reference_attention(q, k, v, causal=causal),
        atol=2e-5, rtol=2e-5)


def _run_cli(*argv, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "tpu_comm_torch", *argv], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout,
    )


def test_cli_attention_on_8_ranks_prints_a_row(tmp_path):
    res = _run_cli("attention", "--backend", "cpu", "--n-devices", "8",
                   "--seq", "256", "--head-dim", "16", "--iters", "2",
                   "--warmup", "0", "--reps", "1", "--jsonl",
                   str(tmp_path / "rows.jsonl"))
    assert res.returncode == 0, res.stderr
    (row,) = [json.loads(line) for line in res.stdout.strip().splitlines()]
    (bank,) = [json.loads(line) for line in
               (tmp_path / "rows.jsonl").read_text().splitlines()]
    assert validate_row(bank) == ([], [])
    assert (row["workload"], row["mesh"], row["verified"],
            row["platform"]) == ("attention-ring", [8], True, "cpu")
    assert row["ring_bytes_per_chip_per_iter"] == 2 * 32 * 8 * 16 * 4 * 7


def test_cli_attention_defaults_to_the_card_and_refuses_without_one(capsys):
    assert cli.main(["attention", "--seq", "64"]) == 2
    assert "no CUDA device is available" in capsys.readouterr().err


@pytest.mark.parametrize("argv,message", [
    (["--n-devices", "0"], "--n-devices must be >= 1"),
    (["--n-devices", "8", "--seq", "100"], "seq 100 not divisible by 8"),
    (["--n-devices", "3", "--seq", "96"], "heads 8 not divisible by 3"),
])
def test_cli_attention_refuses_bad_runs(capsys, argv, message):
    assert cli.main(["attention", "--backend", "cpu", *argv]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and message in err


@pytest.mark.parametrize("flag", [
    ["--impl", "flash"], ["--dtype", "float16"], ["--trace", "out.json"],
    ["--backend", "cpu-sim"],
])
def test_cli_attention_refuses_flags_and_names_it_does_not_have(flag):
    with pytest.raises(SystemExit) as e:
        cli.main(["attention", *flag])
    assert e.value.code == 2
