"""The port's halo microbench and exchange shaping held against the JAX
package, on the CPU: the pattern math, the narrow-wire and partitioned
exchanges, the chained halo loop, the two sweeps (``halo``,
``halosweep``), their rows and their CLI.

The port's side runs on 4 ``gloo`` ranks, started once for this file
with every case in that one spawn (``torch_halo_cases.run_cases``); the
JAX side runs the same seeded fields on cpu-sim devices. Meshes: ``4``
(1D), ``2,2`` (2D) and ``2,2,1`` (3D).

Contract: bitwise. The wire ghosts are JAX's, which are the exact ghosts
pushed through a float32 -> wire -> float32 cast; the partitioned ghosts
are the parallel exchange's, for any part count (ragged spans, more
parts than cells); the halo loop's field is JAX's ``_halo_loop``'s
(``(edge + ghost) * 0.5`` in the field's dtype, the halving exact).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_halo_cases as hcases
import torch_mesh_cases as cases
from tpu_comm.analysis.rowschema import validate_row
from tpu_comm.bench import halosweep as jsweep
from tpu_comm.comm import halo as jhalo
from tpu_comm.comm import patterns as jpatterns
from tpu_comm.domain import Decomposition as JDecomposition
from tpu_comm.topo import make_cart_mesh as jmake_cart_mesh
from tpu_comm_torch import cli
from tpu_comm_torch.bench import halosweep as psweep
from tpu_comm_torch.bench.timing import emit_jsonl
from tpu_comm_torch.comm import launch
from tpu_comm_torch.comm import patterns as ppatterns

#: global shape and mesh per dim of the 4-rank spawn
LAYOUTS = {
    1: ((64,), (4,)),
    2: ((16, 24), (2, 2)),
    3: ((8, 8, 12), (2, 2, 1)),
}
BCS = ("dirichlet", "periodic")
WIRES = ("bfloat16", "float16")
#: sub-slabs a face: one, two, a ragged three, more than cells
PARTS = (1, 2, 3, 1000)
#: the halo loop's runs: (dim, periodic, width, wire)
LOOP_RUNS = [
    (dim, periodic, width, wire)
    for dim in LAYOUTS
    for periodic in (True, False)
    for width in (1, 2)
    for wire in (None, "bfloat16")
]
LOOP_ITERS = 3
#: the identity fields of a halo row
IDENTITY = ("workload", "mesh", "local_size", "size",
            "halo_bytes_per_chip_per_iter", "dtype", "width", "iters")
#: the halo sweeps the spawn runs: name -> config (2D mesh 2,2)
SWEEPS = {
    "plain": {},
    "wire": {"halo_wire": "bfloat16"},
    "open": {"periodic": False, "width": 2},
}


def _field(dim):
    return cases.field(LAYOUTS[dim][0], 300 + dim)


def _jax_per_rank(dim, bc, fn, n_out=1, u0=None, mesh=None):
    """Run ``fn(block, cart)`` under shard_map on the JAX mesh; per
    output a list of the ranks' results (rank = row-major coords)."""
    gshape, lmesh = LAYOUTS[dim]
    mesh = mesh or lmesh
    u0 = _field(dim) if u0 is None else u0
    cart = jmake_cart_mesh(dim, backend="cpu-sim", shape=mesh,
                           periodic=bc == "periodic")
    dec = JDecomposition(cart, u0.shape)
    spec = dec.spec
    outs = jax.shard_map(
        lambda b: fn(b, cart), mesh=cart.mesh, in_specs=spec,
        out_specs=(spec,) * n_out if n_out > 1 else spec, check_vma=False,
    )(dec.scatter(jnp.asarray(u0)))
    if n_out == 1:
        outs = (outs,)
    per_output = []
    for out in outs:
        out = np.asarray(out.astype(jnp.float32))
        local = tuple(s // p for s, p in zip(out.shape, mesh))
        blocks = []
        for rank in range(int(np.prod(mesh))):
            coords = np.unravel_index(rank, mesh)
            blocks.append(out[tuple(
                slice(c * n, (c + 1) * n) for c, n in zip(coords, local)
            )])
        per_output.append(blocks)
    return per_output if n_out > 1 else per_output[0]


def _roundtrip(x: np.ndarray, wire: str) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(wire).astype(jnp.float32))


@pytest.fixture(scope="module")
def ranks():
    todo = {}
    for dim, (gshape, mesh) in LAYOUTS.items():
        for bc in BCS:
            p = {"u0": _field(dim), "mesh": mesh, "bc": bc}
            todo["exchange", dim, bc, None] = ("exchange", p)
            for wire in WIRES:
                todo["exchange", dim, bc, wire] = ("exchange",
                                                   {**p, "wire": wire})
            for parts in PARTS:
                todo["parts", dim, bc, parts] = ("exchange",
                                                 {**p, "parts": parts})
            todo["parts-wire", dim, bc] = (
                "exchange", {**p, "parts": 3, "wire": "bfloat16"})
            for width in (1, 2):
                todo["pad-wire", dim, bc, width] = (
                    "pad_halo_wire", {**p, "wire": "bfloat16",
                                      "width": width})
    for dim, periodic, width, wire in LOOP_RUNS:
        gshape, mesh = LAYOUTS[dim]
        todo["loop", dim, periodic, width, wire] = ("halo_loop", {
            "u0": _field(dim), "mesh": mesh,
            "bc": "periodic" if periodic else "dirichlet",
            "iters": LOOP_ITERS, "width": width, "wire": wire,
        })
    common = dict(dim=2, mesh=(2, 2), backend="cpu", min_bytes=4096,
                  max_bytes=16384, iters=2, warmup=1, reps=1)
    for name, extra in SWEEPS.items():
        todo["sweep", name] = ("halo_sweep", {**common, **extra})
    todo["deep"] = ("deep_sweep", dict(
        dim=2, size=32, mesh=(2, 2), widths=(1, 2), iters=4,
        backend="cpu", warmup=1, reps=1, fuse_steps=2))
    # one thread per rank: four ranks run beside the other test workers
    with pytest.MonkeyPatch.context() as env:
        env.setenv("OMP_NUM_THREADS", "1")
        return launch.run_ranks(hcases.run_cases, 4, "gloo", (todo,),
                                timeout_s=300)


# ------------------------------------------------------ pattern math

SPANS = [(n, parts) for n in (0, 1, 5, 16, 17, 128) for parts in
         (1, 2, 3, 7, 200)]
SHAPES = [(64,), (16, 24), (24, 16), (8, 8, 12), (12, 8, 8), (7, 9, 9)]
DEEP = [
    (local, mesh, item, width)
    for local, mesh in (((64,), (4,)), ((16, 32), (4, 2)),
                        ((16, 32), (1, 2)), ((8, 8, 12), (2, 2, 1)),
                        ((8, 8, 8), (1, 1, 1)), ((6, 10, 14), (2, 3, 2)))
    for item in (2, 4)
    for width in (1, 2, 3, 4, 8)
]


@pytest.mark.parametrize("n,parts", SPANS)
def test_split_spans_equals_jax(n, parts):
    assert ppatterns.split_spans(n, parts) == jpatterns.split_spans(n, parts)


@pytest.mark.parametrize("shape", SHAPES)
def test_partition_axis_equals_jax(shape):
    for axis in range(len(shape)):
        assert (ppatterns.partition_axis(shape, axis)
                == jpatterns.partition_axis(shape, axis))


@pytest.mark.parametrize("local,mesh,item,width", DEEP)
def test_deep_halo_pricing_equals_jax(local, mesh, item, width):
    assert (ppatterns.deep_halo_window_bytes_model(local, mesh, item, width)
            == jpatterns.deep_halo_window_bytes_model(local, mesh, item,
                                                      width))
    assert (ppatterns.deep_halo_redundant_cells(local, width)
            == jpatterns.deep_halo_redundant_cells(local, width))
    assert (ppatterns.deep_halo_model(local, mesh, item, width)
            == jpatterns.deep_halo_model(local, mesh, item, width))


def test_pattern_refusals_and_ladder_equal_jax():
    assert ppatterns.HALO_WIDTH_LADDER == jpatterns.HALO_WIDTH_LADDER
    for fn, args in (("split_spans", (8, 0)),
                     ("deep_halo_window_bytes_model", ((8,), (2,), 4, 0)),
                     ("deep_halo_redundant_cells", ((8,), 0))):
        with pytest.raises(ValueError) as want:
            getattr(jpatterns, fn)(*args)
        with pytest.raises(ValueError) as got:
            getattr(ppatterns, fn)(*args)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------ the exchanges

def _jax_ghosts(dim, bc, exchange):
    """Every axis' ghosts of JAX's ``exchange(block, cart)`` per rank:
    ``[axis] -> (lo per rank, hi per rank)``."""
    flat = _jax_per_rank(
        dim, bc,
        lambda b, cart: tuple(g for _, lo, hi in exchange(b, cart)
                              for g in (lo, hi)),
        n_out=2 * dim,
    )
    return [(flat[2 * a], flat[2 * a + 1]) for a in range(dim)]


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("dim", list(LAYOUTS))
def test_wire_ghosts_equal_jax_cast_oracle(ranks, dim, bc, wire):
    """Each ghost is the exact ghost pushed through a float32 -> wire ->
    float32 round trip (JAX's contract), widened back on receipt, and
    equal to JAX's wire ghost."""
    got = ranks["exchange", dim, bc, wire]
    exact = ranks["exchange", dim, bc, None]
    # JAX's own wire ghosts once a layout (the cast oracle covers both)
    want = _jax_ghosts(dim, bc, lambda b, cart: jhalo.exchange_ghosts(
        b, cart, wire_dtype=wire)) if wire == "bfloat16" else None
    for rank, ((ghosts, same), (plain, _)) in enumerate(zip(got, exact)):
        assert same  # widened to the block's dtype
        for axis in range(dim):
            a, lo, hi = ghosts[axis]
            _, plo, phi = plain[axis]
            assert a == axis
            np.testing.assert_array_equal(lo, _roundtrip(plo, wire))
            np.testing.assert_array_equal(hi, _roundtrip(phi, wire))
            if want is not None:
                np.testing.assert_array_equal(lo, want[axis][0][rank])
                np.testing.assert_array_equal(hi, want[axis][1][rank])
    # the cast is live: some ghost value rounds
    if bc == "periodic":
        assert any(not np.array_equal(g[0][a][1], p[0][a][1])
                   for g, p in zip(got, exact) for a in range(dim))


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("dim,width", [(1, 1), (1, 2), (2, 1), (2, 2),
                                       (3, 2)])
def test_chained_wire_exchange_equals_jax(ranks, dim, bc, width):
    """The chained exchange with a wire: a later axis' slabs carry the
    earlier ghosts, widened and narrowed again, as JAX's pad_halo."""
    want = _jax_per_rank(
        dim, bc, lambda b, cart: jhalo.pad_halo(
            b, cart, width=width, wire_dtype="bfloat16"))
    for rank, got in enumerate(ranks["pad-wire", dim, bc, width]):
        np.testing.assert_array_equal(got, want[rank])


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("dim", list(LAYOUTS))
def test_partitioned_ghosts_equal_parallel(ranks, dim, bc, parts):
    """Sub-slab ghosts, reassembled, are the parallel exchange's bitwise
    (open edges zero a sub-slab; a 1D block has one part)."""
    for (ghosts, same), (plain, _) in zip(ranks["parts", dim, bc, parts],
                                          ranks["exchange", dim, bc, None]):
        assert same
        for axis, ((a, lo, hi), (_, plo, phi)) in enumerate(zip(ghosts,
                                                                plain)):
            assert a == axis
            np.testing.assert_array_equal(lo, plo)
            np.testing.assert_array_equal(hi, phi)


@pytest.mark.parametrize("dim,parts", [(2, 3), (3, 2)])
def test_partitioned_ghosts_equal_jax(ranks, dim, parts):
    want = _jax_ghosts(dim, "periodic",
                       lambda b, cart: jhalo.exchange_ghosts_partitioned(
                           b, cart, parts=parts))
    for rank, (ghosts, _) in enumerate(ranks["parts", dim, "periodic",
                                             parts]):
        for axis, (_, lo, hi) in enumerate(ghosts):
            np.testing.assert_array_equal(lo, want[axis][0][rank])
            np.testing.assert_array_equal(hi, want[axis][1][rank])


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("dim", list(LAYOUTS))
def test_partitioned_wire_ghosts_equal_parallel_wire(ranks, dim, bc):
    for (ghosts, _), (plain, _) in zip(ranks["parts-wire", dim, bc],
                                       ranks["exchange", dim, bc,
                                             "bfloat16"]):
        for (_, lo, hi), (_, plo, phi) in zip(ghosts, plain):
            np.testing.assert_array_equal(lo, plo)
            np.testing.assert_array_equal(hi, phi)


def test_a_wire_not_narrower_than_the_field_is_refused_as_in_jax():
    import torch

    from tpu_comm_torch.comm import halo as phalo
    from tpu_comm_torch.topo import make_cart_mesh

    cart = make_cart_mesh(1, periodic=True)
    with pytest.raises(ValueError) as got:
        phalo.exchange_ghosts(torch.zeros(8, dtype=torch.bfloat16), cart,
                              wire_dtype="float16")
    with pytest.raises(ValueError) as want:
        jhalo._to_wire(jnp.zeros(8, jnp.bfloat16), "float16")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="floating dtype"):
        phalo.exchange_ghosts(torch.zeros(8), cart, wire_dtype="int8")


# -------------------------------------------------------- the halo loop

def _jax_loop(dim, periodic, width, wire):
    gshape, mesh = LAYOUTS[dim]
    cart = jmake_cart_mesh(dim, backend="cpu-sim", shape=mesh,
                           periodic=periodic)
    dec = JDecomposition(cart, gshape)
    out = jsweep._halo_loop(dec.scatter(jnp.asarray(_field(dim))), cart,
                            LOOP_ITERS, width, wire)
    return np.asarray(dec.gather(out))


@pytest.mark.parametrize("dim,periodic,width,wire", LOOP_RUNS)
def test_halo_loop_equals_jax_bitwise(ranks, dim, periodic, width, wire):
    got = ranks["loop", dim, periodic, width, wire]
    assert all(g[0] is None and g[1] for g in got[1:])
    field, kept = got[0]
    assert kept  # the caller's block is only read
    np.testing.assert_array_equal(field, _jax_loop(dim, periodic, width,
                                                   wire))


@pytest.mark.parametrize("dim,periodic,width,wire", [
    (1, True, 1, None), (2, False, 2, "bfloat16"), (3, True, 1, "float16"),
])
def test_halo_oracle_equals_jax_loop(dim, periodic, width, wire):
    """The port's NumPy oracle (its wire cast done by torch) is one step
    of JAX's loop on a 2-rank-a-axis mesh."""
    mesh = LAYOUTS[dim][1]
    g = np.random.default_rng(dim).standard_normal(
        LAYOUTS[dim][0]).astype(np.float32)
    cart = jmake_cart_mesh(dim, backend="cpu-sim", shape=mesh,
                           periodic=periodic)
    dec = JDecomposition(cart, g.shape)
    want = np.asarray(dec.gather(jsweep._halo_loop(
        dec.scatter(jnp.asarray(g)), cart, 1, width, wire)))
    got = psweep.halo_oracle(g, mesh, (periodic,) * dim, width, wire)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-7)


def test_world_of_one_halo_loop_equals_jax():
    """A mesh of one rank (what one card runs) with no process group: a
    periodic axis wraps onto the rank's own opposite edges, folded in
    place without reading a folded edge."""
    import torch

    from tpu_comm_torch.topo import make_cart_mesh

    u0 = cases.field((6, 8), 5)
    want = np.asarray(jsweep._halo_loop(
        jnp.asarray(u0), jmake_cart_mesh(2, backend="cpu-sim",
                                         shape=(1, 1), periodic=True),
        LOOP_ITERS, 2, None))
    got = psweep.halo_loop(torch.from_numpy(u0),
                           make_cart_mesh(2, periodic=True), LOOP_ITERS, 2)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ the rows

@pytest.mark.parametrize("name", list(SWEEPS))
def test_halo_rows_equal_jax_identity(ranks, name):
    extra = SWEEPS[name]
    rows = ranks["sweep", name][0]
    want = jsweep.run_halo_sweep(jsweep.HaloSweepConfig(
        dim=2, backend="cpu-sim", mesh=(2, 2), min_bytes=4096,
        max_bytes=16384, iters=2, warmup=1, reps=1, **extra))
    assert len(rows) == len(want) == 2
    for row, jrow in zip(rows, want):
        assert {k: row[k] for k in IDENTITY} == {k: jrow[k] for k in IDENTITY}
        assert row.get("wire_dtype") == jrow.get("wire_dtype")
        assert set(jrow) - {"platform"} <= set(row)
        assert row["verified"] is True and row["platform"] == "cpu"
        assert row["halo_bytes_per_chip_per_iter"] > 0
        assert validate_row(json.loads(emit_jsonl(row))) == ([], [])


def test_deep_sweep_rows_and_summary(ranks):
    rows, summary = ranks["deep"][0]
    assert [r["halo_width"] for r in rows] == [1, 2]
    for r in rows:
        assert r["verified"] and r["fuse_steps"] == 2
        assert validate_row(json.loads(emit_jsonl(r))) == ([], [])
        m = jpatterns.deep_halo_model((16, 16), (2, 2), 4, r["halo_width"])
        assert r["window_wire_bytes_per_chip"] == \
            m["window_wire_bytes_per_chip"]
        assert r["halo_bytes_per_chip_per_iter"] == \
            m["halo_bytes_per_chip_per_iter"]
    assert summary["mode"] == "halosweep"
    assert summary["tuned_table_width"] is None
    assert summary["widths"] == [1, 2] and summary["verified"]
    assert set(summary["measured_secs_per_iter"]) == {1, 2}


# ------------------------------------------------------ host-side math

@pytest.mark.parametrize("block_bytes", [16, 1 << 12, 1 << 14, 1 << 20,
                                         1 << 26, 3 << 20])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_local_shape_equals_jax(block_bytes, dim):
    for itemsize in (2, 4):
        for width in (1, 2, 4):
            assert (psweep._local_shape(block_bytes, dim, itemsize, width)
                    == jsweep._local_shape(block_bytes, dim, itemsize,
                                           width))


FITS = [
    ([1, 2, 4, 8], [4e-3, 2.5e-3, 2e-3, 2.6e-3], (32, 32), (2, 2)),
    ([1, 2, 4], [1e-3, 1e-3, 1e-3], (64,), (4,)),
    ([1, 2], [None, 1e-3], (16, 16), (2, 2)),
    ([2, 4, 8], [0.0, 3e-4, 5e-4], (8, 8, 16), (2, 2, 1)),
    ([1, 4], [2e-3, 1e-3], (8, 8, 16), (2, 2, 2)),
]


@pytest.mark.parametrize("widths,secs,local,mesh", FITS)
def test_fit_crossover_model_equals_jax(widths, secs, local, mesh):
    assert (psweep.fit_crossover_model(widths, secs, local, mesh)
            == jsweep.fit_crossover_model(widths, secs, local, mesh))


HALO_REFUSALS = [
    {"dim": 4}, {"width": 0}, {"min_bytes": 1 << 20, "max_bytes": 1 << 10},
    {"dtype": "bfloat16", "halo_wire": "float16"},
]


@pytest.mark.parametrize("bad", HALO_REFUSALS)
def test_halo_sweep_refusals_equal_jax(bad):
    with pytest.raises(ValueError) as want:
        jsweep.run_halo_sweep(jsweep.HaloSweepConfig(backend="cpu-sim",
                                                     **bad))
    with pytest.raises(ValueError) as got:
        psweep.run_halo_sweep(psweep.HaloSweepConfig(backend="cpu", **bad))
    assert str(got.value) == str(want.value)


DEEP_REFUSALS = [
    {"mesh": None},
    {"size": 66},
    {"widths": (1, 3), "iters": 8},
    {"widths": (2, 2)},
    {"widths": (1, 32), "iters": 32},
    {"widths": (0,)},
    {"widths": (1, 4), "fuse_steps": 2},
]


@pytest.mark.parametrize("bad", DEEP_REFUSALS)
def test_deep_sweep_refusals_equal_jax(bad):
    """Every width is checked before the first one runs, with JAX's
    messages (``test_deep_halo.py``'s cases)."""
    cfg = {"dim": 2, "size": 64, "mesh": (4, 2), "iters": 8, **bad}
    with pytest.raises(ValueError) as want:
        jsweep.run_deep_halo_sweep(jsweep.DeepHaloSweepConfig(
            backend="cpu-sim", **cfg))
    with pytest.raises(ValueError) as got:
        psweep.run_deep_halo_sweep(psweep.DeepHaloSweepConfig(
            backend="cpu", **cfg))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- CLI

def test_cli_halo_on_4_ranks(tmp_path, capsys):
    path = tmp_path / "rows.jsonl"
    assert cli.main(["halo", "--backend", "cpu", "--dim", "2", "--mesh",
                     "2,2", "--min-bytes", "4096", "--max-bytes", "16384",
                     "--iters", "2", "--reps", "2", "--jsonl",
                     str(path)]) == 0
    printed = [json.loads(line)
               for line in capsys.readouterr().out.splitlines()]
    banked = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["size"] for r in printed] == [4096, 16384]
    for row in banked:
        assert row["verified"] and row["workload"] == "halo2d"
        assert validate_row(row) == ([], [])


def test_cli_halosweep_on_4_ranks(capsys):
    assert cli.main(["halosweep", "--backend", "cpu", "--dim", "2",
                     "--size", "64", "--mesh", "2,2", "--widths", "1,4",
                     "--iters", "8", "--reps", "1", "--warmup", "1"]) == 0
    out = capsys.readouterr()
    lines = [json.loads(line) for line in out.out.splitlines()]
    rows, summary = lines[:-1], lines[-1]
    assert [r["halo_width"] for r in rows] == [1, 4]
    for r in rows:
        assert r["verified"] and validate_row(
            json.loads(emit_jsonl(r))) == ([], [])
    assert summary["mode"] == "halosweep" and summary["widths"] == [1, 4]
    assert "crossover: measured best k=" in out.err


@pytest.mark.parametrize("argv", [
    ["halosweep", "--dim", "2", "--size", "64", "--mesh", "4,2", "--iters",
     "8", "--widths", "1,3"],
    ["halosweep", "--dim", "2", "--size", "64", "--mesh", "4,2", "--iters",
     "8", "--widths", "2,2"],
    ["halosweep", "--dim", "2", "--size", "64", "--mesh", "4,2", "--iters",
     "32", "--widths", "1,32"],
    ["halosweep", "--dim", "2", "--mesh", "2,2", "--widths", "1,x"],
    ["halo", "--dim", "3", "--mesh", "2,2"],
    ["halo", "--dim", "2", "--width", "0"],
    ["halo", "--dim", "2", "--dtype", "float16", "--halo-wire",
     "bfloat16"],
])
def test_cli_refuses_before_it_starts_a_rank(capsys, argv):
    assert cli.main([*argv[:1], "--backend", "cpu", *argv[1:]]) == 2
    out = capsys.readouterr()
    assert out.out.strip() == "" and out.err.startswith("error: ")


def test_cli_halo_defaults_to_the_card_and_refuses_without_one(capsys):
    assert cli.main(["halo", "--dim", "1", "--max-bytes", "16384"]) == 2
    assert "no CUDA device is available" in capsys.readouterr().err
