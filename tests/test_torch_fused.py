"""The port's distributed stencil shaping axes held against the JAX
package, on the CPU: the ``partitioned`` arm, the deep-halo window
(``halo_width``), the narrow halo wire (``halo_wire``) through every arm
that takes it, the fused chain (``run_distributed_fused``), and the
driver's checks, rows and CLI for them.

The port's side runs on 4 ``gloo`` ranks, started once for this file
(``torch_halo_cases.run_cases``), and at world size 1 in process; the
JAX side runs ``run_distributed`` on cpu-sim devices (Pallas kernels in
interpret mode, as the JAX package's own tests run them).

Contract: the gathered float32 field is bitwise JAX's for ``partitioned``
(and bitwise the port's ``overlap``), for the deep window at k = 1, 2, 4
in each bc (and at k = 1 bitwise the port's ``torch`` arm; one exception,
derived at its test: JAX's own 3D periodic window at k > 1 is 1 ulp off
its per-step run, and the port's, bitwise the serial golden, is held to
JAX's float32 envelope there), and with a
bfloat16 wire for the ``torch``, ``overlap``, ``block``, ``multi`` and
``wave`` arms and a box stencil: the port narrows and widens each ghost
where JAX does, and the arms' float32 arithmetic is JAX's. The fused
chain is bitwise the unfused run, returns JAX's dispatch count and never
writes the caller's block; on the CPU it runs eagerly (the CUDA graph
replay is checked on the card, ``tests/test_torch_cuda.py``).
"""

import json

import numpy as np
import pytest

import jax.numpy as jnp

import torch_halo_cases as hcases
import torch_mesh_cases as cases
from tpu_comm.analysis.rowschema import validate_row
from tpu_comm.bench import stencil as jstencil
from tpu_comm.domain import Decomposition as JDecomposition
from tpu_comm.kernels import distributed as jdist
from tpu_comm.topo import make_cart_mesh as jmake_cart_mesh
from tpu_comm_torch import cli
from tpu_comm_torch.bench import stencil as pstencil
from tpu_comm_torch.bench.timing import emit_jsonl
from tpu_comm_torch.comm import launch, patterns
from tpu_comm_torch.domain import Decomposition
from tpu_comm_torch.kernels import distributed as pdist
from tpu_comm_torch.kernels import reference
from tpu_comm_torch.topo import make_cart_mesh

#: global shape and mesh per dim: local blocks the TPU kernels accept
LAYOUTS = {
    1: ((4096,), (4,)),
    2: ((16, 256), (2, 2)),
    3: ((8, 16, 128), (2, 2, 1)),
}
BCS = ("dirichlet", "periodic")
ITERS = 4
#: the port's arm -> the JAX package's
JAX_IMPL = {"torch": "lax", "overlap": "overlap", "block": "pallas",
            "stream": "pallas-stream", "multi": "multi",
            "wave": "pallas-wave", "partitioned": "partitioned"}
PARTS = (1, 2, 3, 1000)
WIDTHS = (1, 2, 4)
#: the bfloat16-wire runs: (name, dim, port arm, options)
WIRE_RUNS = [
    ("torch-1d", 1, "torch", {}),
    ("torch-3d", 3, "torch", {}),
    ("overlap-2d", 2, "overlap", {}),
    ("block-2d", 2, "block", {}),
    ("block-3d-pack", 3, "block", {"pack": "kernel"}),
    ("multi-2d", 2, "multi", {"t_steps": 2}),
    ("wave-2d", 2, "wave", {}),
    ("partitioned-2d", 2, "partitioned", {"halo_parts": 3}),
    ("box9-overlap", 2, "overlap", {"stencil": "9pt"}),
    ("box9-block", 2, "block", {"stencil": "9pt"}),
]
#: the fused chains: (name, dim, arm, iters, fuse_steps, options)
FUSED_RUNS = [
    ("overlap-1", 2, "overlap", 4, 1, {}),
    ("block-2", 2, "block", 4, 2, {}),
    ("stream-4", 3, "stream", 4, 4, {}),
    ("partitioned-2", 3, "partitioned", 4, 2, {"halo_parts": 2}),
    ("wave-4", 1, "wave", 4, 4, {}),
    ("torch-3", 1, "torch", 6, 3, {}),
    ("deep-4", 2, "overlap", 8, 4, {"halo_width": 2}),
    ("wire-2", 2, "block", 4, 2, {"halo_wire": "bfloat16"}),
    ("box27-2", 3, "block", 4, 2, {"stencil": "27pt"}),
]


def _field(dim, seed=0):
    return cases.field(LAYOUTS[dim][0], 400 + 10 * dim + seed)


def _jax_run(dim, iters, bc, impl, **opts):
    gshape, mesh = LAYOUTS[dim]
    cart = jmake_cart_mesh(dim, backend="cpu-sim", shape=mesh,
                           periodic=bc == "periodic")
    dec = JDecomposition(cart, gshape)
    u = dec.scatter(jnp.asarray(_field(dim)))
    if impl in ("block", "stream", "wave") or opts.get("pack") == "kernel":
        opts["interpret"] = True
    if opts.get("pack") == "kernel":
        opts["pack"] = "pallas"
    if impl == "stream" and opts.get("stencil", "star") == "star":
        opts.update({1: {"rows_per_chunk": 8}, 2: {"rows_per_chunk": 8},
                     3: {"planes_per_chunk": 2}}[dim])
    out = jdist.run_distributed(u, dec, iters, bc, JAX_IMPL[impl], **opts)
    return np.asarray(dec.gather(out))


def _case(dim, bc, impl, iters=ITERS, **opts):
    gshape, mesh = LAYOUTS[dim]
    return {"u0": _field(dim), "mesh": mesh, "bc": bc, "impl": impl,
            "iters": iters, "opts": opts}


@pytest.fixture(scope="module")
def ranks():
    todo = {}
    for dim in LAYOUTS:
        for bc in BCS:
            todo["overlap", dim, bc] = ("dist", _case(dim, bc, "overlap"))
            todo["torch", dim, bc] = ("dist", _case(dim, bc, "torch",
                                                    iters=8))
            for parts in PARTS:
                todo["parts", dim, bc, parts] = ("dist", _case(
                    dim, bc, "partitioned", halo_parts=parts))
            for k in WIDTHS:
                todo["deep", dim, bc, k] = ("dist", _case(
                    dim, bc, "torch" if k != 2 else "overlap", iters=8,
                    halo_width=k))
    for name, dim, impl, opts in WIRE_RUNS:
        for bc in BCS:
            todo["wire", name, bc] = ("dist", _case(
                dim, bc, impl, halo_wire="bfloat16", **opts))
    for name, dim, impl, iters, fuse, opts in FUSED_RUNS:
        for bc in BCS:
            p = _case(dim, bc, impl, iters=iters, **opts)
            todo["fused", name, bc] = ("fused", {**p, "fuse_steps": fuse})
            todo["unfused", name, bc] = ("dist", p)
    common = dict(dim=2, size=32, iters=4, mesh=(2, 2), backend="cpu",
                  warmup=1, reps=2, verify=True, verify_iters=3)
    for name, extra in BENCH.items():
        todo["bench", name] = ("bench", {**common, **extra})
    # one thread per rank: four ranks run beside the other test workers
    with pytest.MonkeyPatch.context() as env:
        env.setenv("OMP_NUM_THREADS", "1")
        return launch.run_ranks(hcases.run_cases, 4, "gloo", (todo,),
                                timeout_s=300)


def _root(got):
    assert all(g is None for g in got[1:])
    return got[0]


# ------------------------------------------------------- partitioned

@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("dim", list(LAYOUTS))
def test_partitioned_equals_jax_bitwise(ranks, dim, bc):
    want = _jax_run(dim, ITERS, bc, "partitioned", halo_parts=3)
    np.testing.assert_array_equal(_root(ranks["parts", dim, bc, 3]), want)


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("dim", list(LAYOUTS))
def test_partitioned_equals_overlap_bitwise(ranks, dim, bc, parts):
    np.testing.assert_array_equal(_root(ranks["parts", dim, bc, parts]),
                                  _root(ranks["overlap", dim, bc]))


# ------------------------------------------------------ deep-halo window

@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("dim", list(LAYOUTS))
def test_deep_window_equals_jax_bitwise(ranks, dim, bc, k):
    """One chained width-k exchange, k shrinking steps, the ring planes
    re-frozen by face copies: JAX's window bitwise (its ``lax`` arm; the
    port's ``torch`` and ``overlap`` run the same window)."""
    want = _jax_run(dim, 8, bc, "torch", halo_width=k)
    got = _root(ranks["deep", dim, bc, k])
    if (dim, bc) == (3, "periodic") and k > 1:
        # JAX's own window is off its per-step run here: XLA fuses the k
        # exchange-free periodic 3D steps into one loop and re-associates
        # within it (its float32 window differs from its lax arm and from
        # the serial golden by 1 ulp; the JAX driver's float32 envelope,
        # one ulp of the field's scale a step, allows for that). The
        # port's window rounds as the per-step golden, bitwise, so it is
        # within that envelope of JAX's.
        np.testing.assert_array_equal(
            got, reference.jacobi_run(_field(dim), 8, bc=bc))
        assert np.abs(got - want).max() <= 2.0 ** -23 * 8 * np.abs(
            want).max()
        return
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("dim", list(LAYOUTS))
def test_deep_window_of_width_one_is_the_torch_arm(ranks, dim, bc):
    gshape, mesh = LAYOUTS[dim]
    u0 = _field(dim)
    dec = Decomposition(make_cart_mesh(dim, periodic=bc == "periodic"),
                        gshape)
    want = dec.gather(pdist.run_distributed(dec.scatter(u0), dec, 8, bc=bc,
                                            impl="torch"))
    got = dec.gather(pdist.run_distributed(dec.scatter(u0), dec, 8, bc=bc,
                                           impl="torch", halo_width=1))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_root(ranks["deep", dim, bc, 1]),
                                  _root(ranks["torch", dim, bc]))


# ------------------------------------------------------------- the wire

@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("name,dim,impl,opts", WIRE_RUNS)
def test_wire_run_equals_jax_bitwise(ranks, name, dim, impl, opts, bc):
    want = _jax_run(dim, ITERS, bc, impl, halo_wire="bfloat16", **opts)
    got = _root(ranks["wire", name, bc])
    np.testing.assert_array_equal(got, want)


def test_the_wire_is_live_and_within_jax_envelope(ranks):
    """A periodic bfloat16 wire moves the field off the exact run, by no
    more than the stencil driver's wire envelope (JAX's, one bfloat16 unit
    roundoff of the field's scale a step)."""
    got = _root(ranks["wire", "overlap-2d", "periodic"])
    exact = _root(ranks["overlap", 2, "periodic"])
    assert not np.array_equal(got, exact)
    pstencil.check_against_golden(got, exact, "float32", iters=ITERS,
                                  halo_wire="bfloat16")
    with pytest.raises(AssertionError):
        pstencil.check_against_golden(got, exact, "float32", iters=ITERS)


# ----------------------------------------------------------- fused chain

@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("name,dim,impl,iters,fuse,opts", FUSED_RUNS)
def test_fused_chain_equals_unfused_bitwise(ranks, name, dim, impl, iters,
                                            fuse, opts, bc):
    got = ranks["fused", name, bc]
    field, n, kept = got[0]
    assert all(g[0] is None for g in got[1:])
    assert all(g[1] == n and g[2] for g in got)  # the block is only read
    assert n == iters // fuse
    np.testing.assert_array_equal(field, _root(ranks["unfused", name, bc]))


def test_fused_chain_equals_jax_fused_with_its_dispatch_count():
    gshape, mesh = LAYOUTS[2]
    u0 = _field(2)
    cart = jmake_cart_mesh(2, backend="cpu-sim", shape=(1, 1))
    jdec = JDecomposition(cart, gshape)
    want, want_n = jdist.run_distributed_fused(
        jdec.scatter(jnp.asarray(u0)), jdec, 8, 4, impl="lax",
        halo_width=2)
    dec = Decomposition(make_cart_mesh(2), gshape)
    block = dec.scatter(u0)
    keep = block.clone()
    got, n = pdist.run_distributed_fused(block, dec, 8, 4, impl="torch",
                                         halo_width=2)
    assert n == want_n == 2
    assert (block == keep).all()
    np.testing.assert_array_equal(dec.gather(got), np.asarray(
        jdec.gather(want)))


REFUSALS = [
    # (iters, fuse_steps, port arm, options)
    (10, 4, "torch", {}),
    (4, 0, "torch", {}),
    (8, 4, "multi", {"t_steps": 4}),
    (12, 6, "torch", {"halo_width": 4}),
    (8, 2, "torch", {"halo_width": 4}),
    (8, 4, "torch", {"halo_width": 0}),
]


@pytest.mark.parametrize("iters,fuse,impl,opts", REFUSALS)
def test_fused_refusals_equal_jax(iters, fuse, impl, opts):
    """``test_fused.py``'s and ``test_deep_halo.py``'s refusals, with
    JAX's messages (the arm list names the port's arms)."""
    gshape = (64, 64)
    jcart = jmake_cart_mesh(2, backend="cpu-sim", shape=(1, 1))
    jdec = JDecomposition(jcart, gshape)
    with pytest.raises(ValueError) as want:
        jdist.run_distributed_fused(
            jdec.scatter(jnp.zeros(gshape, jnp.float32)), jdec, iters, fuse,
            impl=JAX_IMPL[impl], **opts)
    dec = Decomposition(make_cart_mesh(2), gshape)
    with pytest.raises(ValueError) as got:
        pdist.run_distributed_fused(dec.scatter(np.zeros(gshape, np.float32)),
                                    dec, iters, fuse, impl=impl, **opts)
    assert str(got.value) == str(want.value).replace(
        "(lax/overlap/partitioned/pallas*)",
        "(torch/overlap/partitioned/block/stream/wave)")


DIST_REFUSALS = [
    # (iters, port arm, options)
    (10, "torch", {"halo_width": 4}),
    (8, "partitioned", {"halo_width": 4}),
    (8, "multi", {"halo_width": 4, "t_steps": 4}),
    (8, "torch", {"halo_width": 0}),
    (8, "partitioned", {"halo_parts": 0}),
    (32, "torch", {"halo_width": 32}),
]


@pytest.mark.parametrize("iters,impl,opts", DIST_REFUSALS)
def test_distributed_refusals_equal_jax(iters, impl, opts):
    gshape, mesh = (64, 64), (4, 2)
    jcart = jmake_cart_mesh(2, backend="cpu-sim", shape=mesh)
    jdec = JDecomposition(jcart, gshape)
    with pytest.raises(ValueError) as want:
        jdist.run_distributed(jdec.scatter(jnp.zeros(gshape, jnp.float32)),
                              jdec, iters, impl=JAX_IMPL[impl], **opts)
    cart = make_cart_mesh(2, shape=mesh, world=8, rank=0)
    dec = Decomposition(cart, gshape)
    with pytest.raises(ValueError) as got:
        pdist.run_distributed(dec.scatter(np.zeros(gshape, np.float32)),
                              dec, iters, impl=impl, **opts)
    want_msg = str(want.value).replace(
        "'lax'/'overlap'", "'torch'/'overlap'").replace(
        "partitioned/pallas arms", "partitioned/kernel arms")
    assert str(got.value) == want_msg


def test_halo_parts_on_another_arm_is_refused():
    """JAX's overlap step ignores a stray ``halo_parts``; the port's
    refuses it (the stencil driver refuses ``--halo-parts`` there in both)."""
    dec = Decomposition(make_cart_mesh(2), (16, 16))
    with pytest.raises(ValueError, match=r"unknown kwargs.*halo_parts"):
        pdist.run_distributed(dec.scatter(np.zeros((16, 16), np.float32)),
                              dec, 2, impl="overlap", halo_parts=2)


def test_convergence_refuses_the_deep_window_and_multi_as_jax():
    gshape = (16, 16)
    jdec = JDecomposition(jmake_cart_mesh(2, backend="cpu-sim",
                                          shape=(1, 1)), gshape)
    ju = jdec.scatter(jnp.zeros(gshape, jnp.float32))
    dec = Decomposition(make_cart_mesh(2), gshape)
    u = dec.scatter(np.zeros(gshape, np.float32))
    for impl, opts in (("torch", {"halo_width": 2}), ("multi", {})):
        with pytest.raises(ValueError) as want:
            jdist.run_distributed_to_convergence(
                ju, jdec, 1e-3, 10, impl=JAX_IMPL[impl], **opts)
        with pytest.raises(ValueError) as got:
            pdist.run_distributed_to_convergence(u, dec, 1e-3, 10,
                                                 impl=impl, **opts)
        assert str(got.value) == str(want.value).replace(
            "impl='lax'/'overlap'", "impl='torch'/'overlap'")


# ---------------------------------------------------- the stencil driver

#: the stencil driver runs of the spawn: name -> StencilConfig fields (2D, 2,2)
BENCH = {
    "fused": {"impl": "block", "fuse_steps": 2},
    "partitioned": {"impl": "partitioned", "halo_parts": 3,
                    "bc": "periodic"},
    "wire": {"impl": "overlap", "halo_wire": "bfloat16", "bc": "periodic"},
    "deep": {"impl": "torch", "halo_width": 2, "fuse_steps": 4,
             "iters": 8},
    "deep-unfused": {"impl": "overlap", "halo_width": 4, "iters": 8,
                     "bc": "periodic"},
}


@pytest.mark.parametrize("name", list(BENCH))
def test_driver_rows_carry_jax_fields(ranks, name):
    extra = BENCH[name]
    row = _root(ranks["bench", name])
    assert row["verified"] is True and row["platform"] == "cpu"
    assert validate_row(json.loads(emit_jsonl(row))) == ([], [])
    iters = extra.get("iters", 4)
    wire_item = 2 if "halo_wire" in extra else 4
    fuse = extra.get("fuse_steps")
    if fuse:
        assert row["fuse_steps"] == fuse
        assert row["dispatches"] == iters // fuse
        assert row["secs_per_dispatch"] == row["secs_per_iter"] * fuse
    else:
        assert "fuse_steps" not in row and "dispatches" not in row
    assert row.get("halo_parts") == extra.get("halo_parts")
    assert row.get("wire_dtype") == extra.get("halo_wire")
    k = extra.get("halo_width")
    if k:
        deep = patterns.deep_halo_model((16, 16), (2, 2), wire_item, k)
        assert row["halo_width"] == k
        assert row["window_wire_bytes_per_chip"] == \
            deep["window_wire_bytes_per_chip"]
        assert row["msgs_per_chip_per_iter"] == \
            deep["msgs_per_chip_per_iter"]
        assert row["redundant_compute_frac"] == round(
            deep["redundant_compute_frac"], 6)
        assert row["halo_bytes_per_chip_per_iter"] == \
            deep["halo_bytes_per_chip_per_iter"]
    else:
        assert row["halo_bytes_per_chip_per_iter"] == \
            patterns.halo_bytes_per_iter_model((16, 16), (2, 2), wire_item)


def test_driver_rows_have_every_jax_field():
    """JAX's row of the same fused, deep, wired run has no field the
    port's lacks."""
    cfg = dict(dim=2, size=32, iters=8, mesh=(1, 1), impl="overlap",
               fuse_steps=4, halo_width=2, halo_wire="bfloat16",
               warmup=1, reps=2)
    jrow = jstencil.run_distributed_bench(jstencil.StencilConfig(
        backend="cpu-sim", **cfg))
    row = pstencil.run_distributed_bench(pstencil.StencilConfig(
        backend="cpu", **cfg))
    for key in ("fuse_steps", "dispatches", "halo_width",
                "window_wire_bytes_per_chip", "msgs_per_chip_per_iter",
                "redundant_compute_frac", "wire_dtype",
                "halo_bytes_per_chip_per_iter"):
        assert row[key] == jrow[key], key
    assert set(jrow) - {"interpret"} <= set(row) | {
        "secs_per_dispatch"} and "secs_per_dispatch" in row


BENCH_REFUSALS = [
    {"dtype": "float16", "halo_wire": "bfloat16"},
    {"halo_wire": "bfloat16", "tol": 0.1},
    {"impl": "overlap", "halo_parts": 2},
    {"impl": "partitioned", "halo_parts": 0},
    {"fuse_steps": 0},
    {"fuse_steps": 2, "tol": 0.1},
    {"impl": "multi", "t_steps": 2, "fuse_steps": 2},
    {"fuse_steps": 3},
    {"halo_width": 0},
    {"impl": "block", "halo_width": 2},
    {"points": 9, "impl": "overlap", "halo_width": 2},
    {"dim": 3, "mesh": (1, 1, 1), "size": 8, "impl": "overlap",
     "pack": "kernel", "halo_width": 2},
    {"halo_width": 2, "tol": 0.1},
    {"halo_width": 3},
    {"halo_width": 4, "fuse_steps": 2},
]


@pytest.mark.parametrize("bad", BENCH_REFUSALS)
def test_driver_refusals_equal_jax(bad):
    """The JAX driver's checks, in its order, with its messages (JAX's
    arm names read as the port's)."""
    cfg = {"dim": 2, "size": 16, "iters": 8, "mesh": (1, 1), **bad}
    jcfg = dict(cfg)
    jcfg["impl"] = {"block": "pallas", "torch": "lax"}.get(
        cfg.get("impl", "auto"), cfg.get("impl", "auto"))
    if cfg.get("pack") == "kernel":
        jcfg["pack"] = "pallas"
    with pytest.raises(ValueError) as want:
        jstencil.run_distributed_bench(jstencil.StencilConfig(
            backend="cpu-sim", **jcfg))
    with pytest.raises(ValueError) as got:
        pstencil.run_distributed_bench(pstencil.StencilConfig(
            backend="cpu", **cfg))
    want_msg = (str(want.value)
                .replace("--impl lax|overlap", "--impl torch|overlap")
                .replace("partitioned/pallas arms",
                         "partitioned and kernel arms")
                .replace("--impl pallas", "--impl block"))
    assert str(got.value) == want_msg


@pytest.mark.parametrize("flag,value", [
    ("halo_wire", "bfloat16"), ("fuse_steps", 2), ("halo_parts", 2),
    ("halo_width", 2),
])
def test_single_device_refusals_equal_jax(flag, value):
    cfg = {"dim": 2, "size": 16, "iters": 4, "impl": "torch", flag: value}
    with pytest.raises(ValueError) as want:
        jstencil.run_single_device(jstencil.StencilConfig(
            backend="cpu-sim", **{**cfg, "impl": "lax"}))
    with pytest.raises(ValueError) as got:
        pstencil.run_single_device(pstencil.StencilConfig(backend="cpu",
                                                          **cfg))
    assert str(got.value) == str(want.value).replace(
        "--impl pallas-multi", "--impl multi")


def test_verify_rounds_up_to_the_window_and_the_chain():
    """``--verify-iters 3`` runs 4 steps under ``--halo-width 2`` and 6
    under ``--fuse-steps 6`` (JAX's rounding), and the check passes."""
    for extra in ({"halo_width": 2}, {"fuse_steps": 6, "iters": 12}):
        row = pstencil.run_distributed_bench(pstencil.StencilConfig(
            dim=2, size=16, mesh=(1, 1), backend="cpu", impl="overlap",
            verify=True, verify_iters=3, warmup=1, reps=1,
            **{"iters": 4, **extra}))
        assert row["verified"] is True


# ------------------------------------------------------------------ CLI

def test_cli_fuse_sweep_prints_a_row_a_value(capsys):
    assert cli.main([
        "stencil", "--backend", "cpu", "--dim", "3", "--size", "16",
        "--mesh", "1,1,1", "--impl", "block", "--pack", "kernel", "--bc",
        "periodic", "--iters", "4", "--fuse-sweep", "1,4", "--verify",
        "--verify-iters", "2", "--warmup", "1", "--reps", "2",
    ]) == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.splitlines()]
    assert [(r["fuse_steps"], r["dispatches"]) for r in rows] == [(1, 4),
                                                                  (4, 1)]
    assert all(r["verified"] for r in rows)


def test_cli_shaping_axes_on_4_ranks(capsys):
    assert cli.main([
        "stencil", "--backend", "cpu", "--dim", "2", "--size", "64",
        "--mesh", "2,2", "--impl", "partitioned", "--halo-parts", "3",
        "--halo-wire", "bfloat16", "--bc", "periodic", "--iters", "4",
        "--fuse-steps", "2", "--verify", "--verify-iters", "3", "--warmup",
        "1", "--reps", "2",
    ]) == 0
    (row,) = [json.loads(line)
              for line in capsys.readouterr().out.splitlines()]
    assert (row["impl"], row["halo_parts"], row["wire_dtype"],
            row["fuse_steps"], row["verified"]) == (
                "partitioned", 3, "bfloat16", 2, True)


@pytest.mark.parametrize("argv", [
    ["--fuse-sweep", "1,x"],
    ["--fuse-sweep", ","],
    ["--fuse-sweep", "1,0"],
    ["--fuse-sweep", "1,3"],
    ["--fuse-sweep", "2,4", "--fuse-steps", "2"],
    ["--fuse-sweep", "1,4", "--halo-width", "2"],
    ["--halo-width", "3", "--impl", "overlap"],
    ["--impl", "block", "--halo-width", "2"],
    ["--halo-parts", "2"],
])
def test_cli_refuses_before_it_starts_a_rank(capsys, argv):
    rc = cli.main(["stencil", "--backend", "cpu", "--dim", "2", "--size",
                   "64", "--mesh", "2,2", "--iters", "4", *argv])
    out = capsys.readouterr()
    assert rc == 2 and out.out.strip() == ""
    assert out.err.startswith("error: ")


def test_cli_stencil_with_a_shaping_axis_refuses_without_a_card(capsys):
    assert cli.main(["stencil", "--dim", "2", "--size", "64", "--mesh",
                     "1,1", "--fuse-steps", "2", "--iters", "4"]) == 2
    assert "no CUDA device is available" in capsys.readouterr().err
