"""The port's membw slice held against the JAX package, on the CPU.

The same seeded NumPy ``x`` and ``b`` (``s = 0.5``, ``z = 0.25``) go
through ``tpu_comm.bench.membw._chained`` (Pallas in interpret mode,
``rows_per_chunk = 8``) and through the port's ``kernels.membw.chained``
on CPU tensors, which runs the kernels' plain versions.

Tolerance:
- copy (chunked, stream, dma), scale and add: bitwise, in every dtype. A
  product or sum of two values of the field dtype, computed in f32 and
  rounded once, is the dtype's correctly rounded result (f32's 24 bits
  cover 2p + 2 for bfloat16 and float16), which is what JAX computes.
- triad: within 1 ulp of the field dtype. XLA may contract ``b + x·s``
  or round ``x·s`` in the narrow dtype; the port does neither.
- the torch arm against the lax arm: the JAX oracle's tolerance
  (``membw.py`` ``_verify``: 1e-6 in float32, 5e-2 below).
A wider difference is a fault of the port (ROADMAP queue C), not a reason
to loosen these.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_comm.analysis.rowschema import validate_row
from tpu_comm.bench import MEMBW_IMPLS as JAX_IMPLS
from tpu_comm.bench import membw as jmembw
from tpu_comm.kernels import tiling as jtiling
from tpu_comm_torch import bench as pbench
from tpu_comm_torch import cli
from tpu_comm_torch.bench import membw as pdriver
from tpu_comm_torch.kernels import membw as pmembw
from tpu_comm_torch.kernels.tiling import check_membw_args, knob_tag

ROOT = Path(__file__).resolve().parents[1]
N = 4 * 8 * 128
DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
    "float16": (jnp.float16, torch.float16),
}
#: (op, JAX arm, knobs) for every pair the JAX package runs, the dma arm
#: at depths 2 and 3, and the aliased knob on the chunked and stream arms
CASES = (
    [(op, "lax", {}) for op in jmembw.OPS]
    + [(op, "pallas", {}) for op in jmembw.OPS]
    + [("copy", "pallas-stream", {}),
       ("copy", "pallas-dma", {"depth": 2}),
       ("copy", "pallas-dma", {"depth": 3}),
       ("triad", "pallas", {"aliased": True}),
       ("copy", "pallas-stream", {"aliased": True})]
)


def _case_id(case):
    op, impl, knobs = case
    return "-".join([op, impl] + [f"{k}{v}" for k, v in knobs.items()])


def _operands(dtype: str, n: int = N, seed: int = 3):
    rng = np.random.default_rng(seed)
    x32 = rng.standard_normal(n).astype(np.float32)
    b32 = rng.standard_normal(n).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jax_in = (jnp.asarray(x32).astype(jdt), jnp.asarray(b32).astype(jdt))
    port_in = (torch.from_numpy(x32).to(tdt), torch.from_numpy(b32).to(tdt))
    return jax_in, port_in


def _bits(a) -> np.ndarray:
    """Raw bit patterns of a JAX result or a port tensor, as uint32/16."""
    if isinstance(a, torch.Tensor):
        view = torch.int32 if a.element_size() == 4 else torch.int16
        a = a.contiguous().view(view).numpy()
    else:
        a = np.asarray(a)
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint16)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in units in the last place between two arrays of raw
    float bits of one width (sign-magnitude mapped onto a line)."""
    sign = 1 << (8 * a.dtype.itemsize - 1)

    def line(bits):
        v = bits.astype(np.int64)
        return np.where(v & sign, -(v & (sign - 1)), v)

    return np.abs(line(a) - line(b))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_one_pass_matches_jax_arm(case, dtype):
    op, impl, knobs = case
    (jx, jb), (tx, tb) = _operands(dtype)
    want = jmembw._chained(
        jx, jb, jnp.asarray(0.5, jnp.float32), jnp.asarray(0.25, jnp.float32),
        op, impl, 1, rows_per_chunk=8, interpret=True,
        aliased=knobs.get("aliased", False), depth=knobs.get("depth", 2),
    )
    got = pmembw.chained(
        tx, tb, 0.5, 0.25, op, pbench.JAX_MEMBW_IMPLS[impl], 1,
        rows_per_chunk=8, aliased=knobs.get("aliased", False),
        depth=knobs.get("depth", 2),
    )
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if impl == "lax":
        tol = 1e-6 if dtype == "float32" else 5e-2
        np.testing.assert_allclose(
            got.double().numpy(), np.asarray(want).astype(np.float64),
            atol=tol, rtol=tol,
        )
    elif op == "triad":
        assert _ulps(_bits(got), _bits(want)).max() <= 1
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))


PORT_PAIRS = (
    [(op, arm, {}) for op in pbench.MEMBW_OPS for arm in ("torch", "chunked")]
    + [("copy", "stream", {}), ("copy", "dma", {"depth": 3}),
       ("scale", "chunked", {"aliased": True}),
       ("copy", "stream", {"aliased": True})]
)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", PORT_PAIRS, ids=_case_id)
def test_timed_loop_operands_chain_to_the_identity(case, dtype):
    """With s = 1 and b = z = 0 every op is the identity, so 7 chained
    passes return the input bit for bit: the property slope timing rests
    on (the JAX suite's ``test_chained_iterations_value_stable``)."""
    op, arm, knobs = case
    _, (tx, _) = _operands(dtype, n=2 * 8 * 128, seed=5)
    got = pmembw.chained(tx, torch.zeros_like(tx), 1.0, 0.0, op, arm, 7,
                         rows_per_chunk=8, **knobs)
    np.testing.assert_array_equal(_bits(got), _bits(tx))


def test_port_names_and_constants_match_the_jax_package():
    assert pbench.MEMBW_OPS == jmembw.OPS
    assert pbench.TRAFFIC == jmembw.TRAFFIC
    assert set(pbench.JAX_MEMBW_IMPLS) == set(JAX_IMPLS)
    assert sorted(pbench.JAX_MEMBW_IMPLS.values()) == sorted(
        pbench.MEMBW_IMPLS
    )
    for aliased in (False, True):
        for depth in (None, 2, 3, 4):
            assert knob_tag(aliased, depth) == jtiling.knob_tag(
                aliased, None, depth
            )


def _port_cfg(**kw):
    base = dict(backend="cpu", size=N, iters=2, warmup=1, reps=1)
    return pdriver.MembwConfig(**{**base, **kw})


@pytest.mark.parametrize("cfg", [
    dict(op="scale", impl="torch"),
    dict(op="triad", impl="chunked", chunk=8, aliased=True),
    dict(op="copy", impl="stream", chunk=8),
    dict(op="copy", impl="dma", chunk=8, depth=3),
], ids=lambda c: f"{c['op']}-{c['impl']}")
def test_driver_row_has_the_jax_rows_identity(tmp_path, cfg):
    """The port's row and the JAX driver's row for the same configuration
    carry the same identity fields, and the port's passes the JAX row
    schema."""
    path = tmp_path / "rows.jsonl"
    # several reps: the slope of two single samples of so short a loop
    # can come out non-positive on a busy machine, and the rate then null
    rec = pdriver.run_membw(_port_cfg(jsonl=str(path), reps=7, **cfg))
    jax_impl = {v: k for k, v in pbench.JAX_MEMBW_IMPLS.items()}[cfg["impl"]]
    jrec = jmembw.run_membw(jmembw.MembwConfig(
        backend="cpu-sim", size=N, iters=2, warmup=1, reps=1,
        **{**cfg, "impl": jax_impl},
    ))
    for field in ("workload", "dtype", "size", "iters", "mesh", "verified",
                  "chunk", "chunk_source", "knobs"):
        assert rec.get(field) == jrec.get(field), field
    assert (rec["impl"], rec["platform"], rec["backend"]) == (
        cfg["impl"], "cpu", "cpu"
    )
    row = json.loads(path.read_text())
    assert validate_row(row) == ([], [])
    assert isinstance(row["gbps_eff"], float) and "t_median_s" in row
    assert row["gbps_eff"] == pytest.approx(
        pbench.TRAFFIC[cfg["op"]] * N * 4 / row["secs_per_iter"] / 1e9
    )



@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", list(pmembw.OP_CODES))
def test_driver_row_reports_the_ops_default_chunk(op, dtype):
    """With no --chunk the chunked arm runs, verifies and reports its op's
    own default: CHUNKED_DEFAULT_CHUNK_BYTES[op] of each operand a CTA,
    whatever the dtype, with chunk_source "auto"."""
    tdt = DTYPES[dtype][1]
    rec = pdriver.run_membw(_port_cfg(op=op, impl="chunked", dtype=dtype))
    assert rec["verified"] is True
    assert rec["chunk_source"] == "auto"
    assert rec["chunk"] == pmembw.default_chunk("chunked", tdt, op)
    assert (rec["chunk"] * 128 * tdt.itemsize
            == pmembw.CHUNKED_DEFAULT_CHUNK_BYTES[op])

def test_cli_both_runs_chunked_then_torch_on_cpu(tmp_path):
    path = tmp_path / "rows.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "tpu_comm_torch", "membw", "--backend", "cpu",
         "--op", "triad", "--impl", "both", "--size", str(N), "--iters",
         "3", "--reps", "2", "--jsonl", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    printed = [json.loads(line) for line in res.stdout.splitlines()]
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    for got in (printed, rows):
        assert [r["impl"] for r in got] == ["chunked", "torch"]
        assert all(r["platform"] == "cpu" and r["verified"] for r in got)
    assert rows[0]["chunk_source"] == "auto" and rows[1]["chunk"] is None


@pytest.mark.parametrize("argv, msg", [
    (["--impl", "torch", "--chunk", "8"], "--chunk applies to the kernel"),
    (["--impl", "chunked", "--depth", "3"], "--depth (ring slots) applies"),
    (["--impl", "dma", "--op", "copy", "--depth", "1"], "--depth must be"),
    (["--impl", "stream", "--op", "scale"], "copy arm"),
    (["--impl", "dma", "--op", "scale"], "copy arm"),
    (["--dimsem", "parallel"], "CUDA blocks are always unordered"),
    (["--impl", "pallas-dma", "--op", "copy"], "the port calls this arm "
                                                "'dma'"),
    (["--impl", "chunked", "--size", "1000"], "multiple of 128"),
    (["--impl", "torch", "--aliased"], "--aliased applies to the kernel"),
    (["--impl", "dma", "--op", "copy", "--aliased"], "does not apply to "
                                                      "the dma arm"),
    # no --backend: the default is the card, which this machine lacks
    ([], "backend=cuda requested but no CUDA device"),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_cli_misuse_exits_2(capsys, argv, msg):
    backend = ["--backend", "cpu"] if argv else []
    rc = cli.main(["membw", *backend, "--size", str(N), "--iters", "2",
                   *argv])
    assert rc == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and msg in err


def test_membw_args_accept_out_is_x_exactly_when_aliased():
    x = torch.zeros(2 * N)
    a, b = x[:N], torch.ones(N)
    assert check_membw_args(a, None, True) is a
    assert check_membw_args(a, a, True) is a
    assert check_membw_args(a, None, False).data_ptr() != a.data_ptr()
    for out, aliased, other, msg in [
        (a, False, (), "must not alias the input unless aliased"),
        (x[64:64 + N], False, (), "must not alias the input unless"),
        (x[64:64 + N], True, (), "out must be the input itself"),
        (torch.zeros(N), True, (), "out must be the input itself"),
        (b, False, (b,), "must not alias the second operand"),
        (torch.zeros(N + 128), False, (), "input's shape"),
        (torch.zeros(N), False, (torch.ones(N + 128),), "every operand"),
    ]:
        with pytest.raises(ValueError, match=msg):
            check_membw_args(a, out, aliased, *other)
    for bad, msg in [(torch.zeros(N + 1), "multiple of 128"),
                     (torch.zeros(N, dtype=torch.float64), "take"),
                     (torch.zeros(2 * N)[::2], "contiguous")]:
        with pytest.raises(ValueError, match=msg):
            check_membw_args(bad, None)


def test_wrappers_refuse_what_their_kernels_do_not_take():
    x = torch.zeros(N)
    with pytest.raises(ValueError, match="needs the second operand"):
        pmembw.step_chunked(x, None, 1.0, "add")
    with pytest.raises(ValueError, match="depth must be"):
        pmembw.step_dma(x, depth=1)
    with pytest.raises(ValueError, match="rows_per_chunk must be"):
        pmembw.step_stream(x, rows_per_chunk=0)
    with pytest.raises(ValueError, match="copy arm"):
        pmembw.chained(x, x, 1.0, 0.0, "triad", "dma", 1)
    with pytest.raises(ValueError, match="impl must be one of"):
        pmembw.chained(x, x, 1.0, 0.0, "copy", "pallas", 1)
    # the CPU runs the plain versions and launches nothing
    before = [w.launches for w in pmembw.WRAPPERS]
    pmembw.chained(x, x, 1.0, 0.0, "copy", "dma", 3)
    assert [w.launches for w in pmembw.WRAPPERS] == before


#: the H100 SXM's figures (132 SMs; 228 KiB of shared memory an SM, 227
#: KiB a CTA) and a smaller card's, for the dma launch plan
CARDS = {
    "h100": dict(sms=132, smem_per_sm=233472, smem_per_cta=232448),
    "small": dict(sms=7, smem_per_sm=102400, smem_per_cta=101376),
}
#: (n, itemsize, rows_per_chunk, depth): the main path's, bfloat16's, a
#: ragged last chunk, fewer chunks than slots on the card, the deepest
#: ring, slots of one row
PLAN_CASES = [
    (1 << 26, 4, 32, 2), (1 << 26, 2, 64, 2), (1 << 26, 4, 64, 3),
    (128 * 8 * 3 + 128, 4, 8, 3), (384, 4, 1, 4), (128, 2, 1, 8),
    (1 << 20, 4, 16, 8), (1 << 20, 2, 3, 5), (4096 * 128 + 384, 4, 4, 2),
]


@pytest.mark.parametrize("card", list(CARDS))
@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_dma_plan_covers_every_chunk_once_and_fits_shared_memory(card, case):
    n, itemsize, rows, depth = case
    limits = CARDS[card]
    plan = pmembw.dma_plan(n, itemsize, rows, depth, **limits)
    nbytes = n * itemsize
    assert plan.chunk_bytes == rows * 128 * itemsize
    assert (plan.n_chunks - 1) * plan.chunk_bytes < nbytes
    assert nbytes <= plan.n_chunks * plan.chunk_bytes
    # each chunk goes to exactly one CTA, and CTAs differ by at most one
    taken = sorted(c for b in range(plan.ctas) for c in plan.chunks_of(b))
    assert taken == list(range(plan.n_chunks))
    counts = [len(plan.chunks_of(b)) for b in range(plan.ctas)]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1
    # a ring fits a CTA, and per_sm of them (with the card's reserve) an
    # SM, and one more would not
    assert plan.ring_bytes == depth * plan.chunk_bytes
    per_cta = (plan.ring_bytes + pmembw.DMA_BARRIER_BYTES
               + pmembw.SMEM_RESERVED_PER_CTA)
    assert plan.ring_bytes + pmembw.DMA_BARRIER_BYTES <= limits["smem_per_cta"]
    assert 1 <= plan.per_sm <= pmembw.MAX_CTAS_PER_SM
    assert plan.per_sm * per_cta <= limits["smem_per_sm"]
    assert (plan.per_sm == pmembw.MAX_CTAS_PER_SM
            or (plan.per_sm + 1) * per_cta > limits["smem_per_sm"])
    assert plan.ctas == min(plan.n_chunks, limits["sms"] * plan.per_sm)


@pytest.mark.parametrize("card", list(CARDS))
def test_dma_plan_refuses_a_ring_that_does_not_fit_a_cta(card):
    limits = CARDS[card]
    rows = limits["smem_per_cta"] // (2 * 128 * 4) + 1
    with pytest.raises(ValueError, match="shared memory a block can use"):
        pmembw.dma_plan(1 << 20, 4, rows, 2, **limits)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("depth", range(2, pmembw.DMA_MAX_DEPTH + 1))
def test_default_dma_slot_fits_the_h100_at_every_depth(dtype, depth):
    """The dma arm's default slot takes every --depth on the H100."""
    tdt = DTYPES[dtype][1]
    rows = pmembw.default_chunk("dma", tdt)
    itemsize = torch.empty((), dtype=tdt).element_size()
    assert rows * 128 * itemsize == pmembw.DMA_DEFAULT_CHUNK_BYTES
    plan = pmembw.dma_plan(1 << 26, itemsize, rows, depth, **CARDS["h100"])
    assert plan.ctas >= CARDS["h100"]["sms"]


#: dma_verify_size on the H100 at the default 16 KiB slots, float32
#: elements by depth (bfloat16: twice as many, the same bytes)
H100_DMA_VERIFY = {2: 9732096, 3: 8650752, 4: 8110080, 5: 6488064,
                   6: 7569408, 7: 8650752, 8: 4866048}


@pytest.mark.parametrize("card", list(CARDS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", range(2, pmembw.DMA_MAX_DEPTH + 1))
def test_dma_verify_size_wraps_every_ring(card, dtype, depth):
    """The dma arm's --verify size: every CTA of dma_plan takes depth + 1
    chunks (each slot refilled once), no fewer elements would do, and
    never more than the measured size, which is verified whole when it
    is smaller."""
    limits = CARDS[card]
    tdt = DTYPES[dtype][1]
    itemsize = torch.empty((), dtype=tdt).element_size()
    default = pmembw.default_chunk("dma", tdt)
    for rows in (default, 1, 8):
        if (depth * rows * 128 * itemsize + pmembw.DMA_BARRIER_BYTES
                > limits["smem_per_cta"]):
            with pytest.raises(ValueError, match="shared memory"):
                pmembw.dma_verify_size(1 << 26, itemsize, rows, depth,
                                       **limits)
            continue
        size = pmembw.dma_verify_size(1 << 26, itemsize, rows, depth,
                                      **limits)
        assert size < 1 << 26 and size % (rows * 128) == 0
        if card == "h100" and rows == default:
            assert size * itemsize == H100_DMA_VERIFY[depth] * 4
        for n, least in ((size, depth + 1), (size - rows * 128, depth)):
            plan = pmembw.dma_plan(n, itemsize, rows, depth, **limits)
            counts = [len(plan.chunks_of(b)) for b in range(plan.ctas)]
            assert min(counts) == least, n
        for n in (size - 128, 128 * 8 * 3 + 128, 128):
            assert pmembw.dma_verify_size(n, itemsize, rows, depth,
                                          **limits) == n


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_default_copy_chunks_are_fixed_bytes_a_cta(dtype):
    tdt = DTYPES[dtype][1]
    itemsize = torch.empty((), dtype=tdt).element_size()
    assert (pmembw.default_chunk("stream", tdt) * 128 * itemsize
            == pmembw.STREAM_DEFAULT_CHUNK_BYTES)
    for op in pmembw.OP_CODES:
        assert (pmembw.default_chunk("chunked", tdt, op) * 128 * itemsize
                == pmembw.CHUNKED_DEFAULT_CHUNK_BYTES[op])
