"""The port's distributed stencil held against the JAX package's, on the
CPU: the local step of every arm, the convergence loop, the benchmark
entry point, its row and its CLI.

The same seeded NumPy field goes through both packages: JAX decomposes
it over cpu-sim devices and runs ``run_distributed`` (Pallas kernels in
interpret mode, as the JAX package's own tests run them); the port
decomposes it over 4 ``gloo`` ranks, started once for this file with
every case in that one spawn (``torch_mesh_cases.run_cases``), and over a
world of one in process.

The box stencils (``stencil="9pt"`` on a 2D mesh, ``"27pt"`` on a 3D
one) run the same way, with the chained ghost exchange; the 27-point one
also on 8 ranks of mesh (2, 2, 2), the one layout where a corner ghost
crosses three links.

The ``multi`` arm (one chained exchange of width-t ghosts, then t steps
of the padded block in the field's dtype) runs for the star in 1D, 2D
and 3D and for both boxes against JAX's ``run_distributed(impl="multi",
t_steps=t)``, on the 4-rank spawn at t = 4, on the 8-rank spawn for the
27-point box at t = 2 (a width-2 corner crosses three links), at world
size 1, and through the driver.

The ``wave`` arm runs for the star in 1D, 2D and 3D and for both boxes
against JAX's ``run_distributed(impl="pallas-wave")``, each bc, on the
4-rank spawn, on the 8-rank spawn (27-point), at world size 1 and
through the driver.

Contract: the gathered field is bitwise equal to JAX's for every arm x
dim x bc, and for the box stencils every arm x bc, ``multi`` and
``wave`` included, in float32 AND in bfloat16 (bound: 0 ulps per step;
the arms round where JAX's do, since
the face recompute, the ``torch`` and ``overlap`` arithmetic run in the
field's dtype with ``1/(2d)``, 1/8 or 1/26 rounded to it, and the
kernels' plain versions compute in float32 and narrow once, as the
Pallas kernels do; the box kernels' global edge rows are recomputed
with the faces, so JAX's field-dtype ``_edge_row`` leaves no trace).
One exception, the 2D star's ``wave`` in bfloat16: JAX recomputes each
block's two seam columns outside its kernel in the field's dtype (two
levels of rounded adds, ROADMAP Trap 4), the port's kernel computes
them in float32 and rounds once, within 2 ulps a step
(``tests/test_torch_wave.py``). The gap spreads one column a step and a
step adds at most 2 ulps to what it inherits (the step averages its
inputs), so after ITERS steps the fields are held to 2 * ITERS ulps of
the field's largest value, and bitwise at least ITERS columns from
every block's seam columns.
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
#: the driver tests' arms: those and the wave
DRIVER_IMPL = {**JAX_IMPL, "wave": "pallas-wave"}
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
#: box stencil -> global shape and mesh of the 4-rank spawn
BOX_LAYOUTS = {"9pt": ((16, 256), (2, 2)), "27pt": ((8, 16, 128), (2, 2, 1))}
BOX_RUNS = [
    (stencil, bc, impl, dtype)
    for stencil in BOX_LAYOUTS
    for bc in ("dirichlet", "periodic")
    for impl in JAX_IMPL
    for dtype in ("float32", "bfloat16")
]
#: box convergence runs: (stencil, arm, bc) -> loop parameters (the
#: golden stops after 18 and 18 steps)
BOX_CONV = {
    ("9pt", "overlap", "dirichlet"): {"tol": 0.1, "max_iters": 60,
                                      "check_every": 3},
    ("27pt", "block", "periodic"): {"tol": 0.05, "max_iters": 60,
                                    "check_every": 3},
}
#: the wave arm's runs on the 4-rank spawn: (stencil of MULTI_LAYOUTS,
#: bc, dtype)
WAVE_RUNS = [
    (stencil, bc, dtype)
    for stencil in ("star1", "star2", "star3", "9pt", "27pt")
    for bc in ("dirichlet", "periodic")
    for dtype in ("float32", "bfloat16")
]
#: a bfloat16 value in [2^e, 2^(e+1)) has ulp 2^(e - 7)
BF16_ULP_EXP = 7
#: the 8-rank spawn: a 27-point field over mesh (2, 2, 2)
CORNER_GSHAPE, CORNER_MESH = (8, 16, 256), (2, 2, 2)
#: the multi arm's steps per exchange on the 4-rank spawn (the 3D local
#: blocks are 4 planes deep: t may not exceed that) and its runs: (stencil
#: of the star of that dim or the box, bc, dtype) over 2 exchanges
MULTI_T = 4
MULTI_LAYOUTS = {
    "star1": LAYOUTS[1], "star2": LAYOUTS[2], "star3": LAYOUTS[3],
    "9pt": BOX_LAYOUTS["9pt"], "27pt": BOX_LAYOUTS["27pt"],
}
MULTI_RUNS = [
    (stencil, bc, dtype)
    for stencil in MULTI_LAYOUTS
    for bc in ("dirichlet", "periodic")
    for dtype in ("float32", "bfloat16")
]


def _multi_stencil(name: str) -> str:
    """The distributed step's ``stencil`` of a MULTI_LAYOUTS key."""
    return "star" if name.startswith("star") else name


def _jax_multi_run(u0, mesh, iters, bc, stencil, t, dtype="float32"):
    dec, u = _jax_setup(u0, mesh, bc, dtype)
    out = jdist.run_distributed(u, dec, iters, bc, "multi", t_steps=t,
                                stencil=stencil)
    return np.asarray(dec.gather(out).astype(np.float32))


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


def _jax_wave_run(u0, mesh, iters, bc, stencil, dtype="float32"):
    """JAX's ``pallas-wave`` on a mesh (its kernels pick their own ring
    blocks)."""
    dec, u = _jax_setup(u0, mesh, bc, dtype)
    out = jdist.run_distributed(u, dec, iters, bc, "pallas-wave",
                                stencil=stencil, interpret=True)
    return np.asarray(dec.gather(out).astype(np.float32))


def assert_wave_equals_jax(got, want, stencil, dtype, local_nx, iters):
    """The module docstring's contract for the ``wave`` arm: bitwise, but
    for the 2D star in bfloat16, within 2 ulps a step of the largest value
    and bitwise ``iters`` columns or more from every block's seams."""
    if stencil != "star2" or dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - BF16_ULP_EXP)
    assert np.abs(got - want).max() <= 2 * iters * ulp
    col = np.arange(want.shape[1]) % local_nx
    far = np.minimum(col, local_nx - 1 - col) >= iters
    np.testing.assert_array_equal(got[:, far], want[:, far])


def _jax_box_run(u0, mesh, iters, bc, impl, stencil, dtype="float32"):
    """JAX's box path (its stream arm picks its own chunk: it takes no
    chunk argument there)."""
    dec, u = _jax_setup(u0, mesh, bc, dtype)
    kw = {"interpret": True} if impl in ("block", "stream") else {}
    out = jdist.run_distributed(u, dec, iters, bc, JAX_IMPL[impl],
                                stencil=stencil, **kw)
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
    for stencil, bc, impl, dtype in BOX_RUNS:
        gshape, mesh = BOX_LAYOUTS[stencil]
        todo["box", stencil, bc, impl, dtype] = ("run", {
            "u0": cases.field(gshape, 60 + gshape[0]), "mesh": mesh,
            "iters": ITERS, "bc": bc, "impl": impl, "dtype": dtype,
            "stencil": stencil,
        })
    for stencil, impl, bc in BOX_CONV:
        gshape, mesh = BOX_LAYOUTS[stencil]
        todo["box-conv", stencil, impl, bc] = ("conv", {
            "u0": cases.field(gshape, 70), "mesh": mesh, "bc": bc,
            "impl": impl, "stencil": stencil, **BOX_CONV[stencil, impl, bc],
        })
    for name, bc, dtype in MULTI_RUNS:
        gshape, mesh = MULTI_LAYOUTS[name]
        todo["multi", name, bc, dtype] = ("run", {
            "u0": cases.field(gshape, 110 + len(gshape)), "mesh": mesh,
            "iters": 2 * MULTI_T, "bc": bc, "impl": "multi",
            "dtype": dtype, "stencil": _multi_stencil(name),
            "t_steps": MULTI_T,
        })
    for name, bc, dtype in WAVE_RUNS:
        gshape, mesh = MULTI_LAYOUTS[name]
        todo["wave", name, bc, dtype] = ("run", {
            "u0": cases.field(gshape, 140 + len(gshape)), "mesh": mesh,
            "iters": ITERS, "bc": bc, "impl": "wave", "dtype": dtype,
            "stencil": _multi_stencil(name),
        })
    todo["verdict"] = ("verdict", {})
    common = dict(dim=2, size=64, iters=4, mesh=(2, 2), backend="cpu",
                  warmup=1, reps=5, verify=True, verify_iters=3)
    todo["bench"] = ("bench", {**common, "impl": "auto"})
    todo["bench-conv"] = ("bench", {**common, "impl": "block", "tol": 0.5,
                                    "check_every": 5, "iters": 50})
    todo["bench-9pt"] = ("bench", {**common, "impl": "auto", "points": 9})
    todo["bench-multi"] = ("bench", {**common, "impl": "multi",
                                     "t_steps": 2})
    todo["bench-wave"] = ("bench", {**common, "impl": "wave",
                                    "bc": "periodic"})
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


@pytest.mark.parametrize("stencil,bc,impl,dtype", BOX_RUNS)
def test_box_mesh_run_equals_jax_bitwise(ranks, stencil, bc, impl, dtype):
    gshape, mesh = BOX_LAYOUTS[stencil]
    u0 = cases.field(gshape, 60 + gshape[0])
    want = _jax_box_run(u0, mesh, ITERS, bc, impl, stencil, dtype)
    got = ranks["box", stencil, bc, impl, dtype]
    assert all(g is None for g in got[1:])
    assert got[0].dtype == np.float32 and got[0].shape == gshape
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("name,bc,dtype", MULTI_RUNS)
def test_multi_mesh_run_equals_jax_bitwise(ranks, name, bc, dtype):
    """Two width-4 exchanges and eight steps on 4 ranks: bitwise in
    float32 and bfloat16 (both round every step in the field's dtype)."""
    gshape, mesh = MULTI_LAYOUTS[name]
    u0 = cases.field(gshape, 110 + len(gshape))
    want = _jax_multi_run(u0, mesh, 2 * MULTI_T, bc, _multi_stencil(name),
                          MULTI_T, dtype)
    got = ranks["multi", name, bc, dtype]
    assert all(g is None for g in got[1:])
    assert got[0].dtype == np.float32 and got[0].shape == gshape
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("name,bc,dtype", WAVE_RUNS)
def test_wave_mesh_run_equals_jax(ranks, name, bc, dtype):
    """``wave`` on 4 ranks against JAX's ``pallas-wave``, every stencil:
    ITERS steps, the module docstring's contract."""
    gshape, mesh = MULTI_LAYOUTS[name]
    u0 = cases.field(gshape, 140 + len(gshape))
    want = _jax_wave_run(u0, mesh, ITERS, bc, _multi_stencil(name), dtype)
    got = ranks["wave", name, bc, dtype]
    assert all(g is None for g in got[1:])
    assert got[0].dtype == np.float32 and got[0].shape == gshape
    assert_wave_equals_jax(got[0], want, name, dtype,
                           gshape[-1] // mesh[-1], ITERS)


@pytest.mark.parametrize("stencil,impl,bc", list(BOX_CONV))
def test_box_convergence_loop_stops_where_jax_stops(ranks, stencil, impl,
                                                    bc):
    gshape, mesh = BOX_LAYOUTS[stencil]
    conv = BOX_CONV[stencil, impl, bc]
    dec, u = _jax_setup(cases.field(gshape, 70), mesh, bc, "float32")
    kw = {"interpret": True} if impl == "block" else {}
    want, want_it, want_res = jdist.run_distributed_to_convergence(
        u, dec, conv["tol"], conv["max_iters"],
        check_every=conv["check_every"], bc=bc, impl=JAX_IMPL[impl],
        stencil=stencil, **kw,
    )
    assert conv["check_every"] < want_it < conv["max_iters"]
    per_rank = ranks["box-conv", stencil, impl, bc]
    assert {(it, res) for _, it, res in per_rank} == {per_rank[0][1:]}
    got, it, res = per_rank[0]
    assert it == want_it
    assert res == pytest.approx(want_res, rel=1e-5) and res <= conv["tol"]
    np.testing.assert_array_equal(got, np.asarray(dec.gather(want)))


@pytest.fixture(scope="module")
def ranks8():
    """One spawn of 8 gloo ranks on mesh (2, 2, 2): every 27-point arm x
    bc, and the chained exchange's padded block."""
    u0 = cases.field(CORNER_GSHAPE, 80)
    todo = {}
    for bc in ("dirichlet", "periodic"):
        for impl in JAX_IMPL:
            todo["run", bc, impl] = ("run", {
                "u0": u0, "mesh": CORNER_MESH, "iters": ITERS, "bc": bc,
                "impl": impl, "stencil": "27pt",
            })
    todo["pad"] = ("pad_halo", {"u0": u0, "mesh": CORNER_MESH,
                                "bc": "periodic"})
    for bc in ("dirichlet", "periodic"):
        todo["multi", bc] = ("run", {
            "u0": u0, "mesh": CORNER_MESH, "iters": 4, "bc": bc,
            "impl": "multi", "stencil": "27pt", "t_steps": 2,
        })
    todo["pad2"] = ("pad_halo", {"u0": u0, "mesh": CORNER_MESH,
                                 "bc": "periodic", "width": 2})
    for bc in ("dirichlet", "periodic"):
        for dtype in ("float32", "bfloat16"):
            todo["wave", bc, dtype] = ("run", {
                "u0": u0, "mesh": CORNER_MESH, "iters": ITERS, "bc": bc,
                "impl": "wave", "stencil": "27pt", "dtype": dtype,
            })
    with pytest.MonkeyPatch.context() as env:
        env.setenv("OMP_NUM_THREADS", "1")
        return launch.run_ranks(cases.run_cases, 8, "gloo", (todo,),
                                timeout_s=300)


@pytest.mark.parametrize("impl", list(JAX_IMPL))
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_27pt_on_8_ranks_equals_jax_bitwise(ranks8, bc, impl):
    u0 = cases.field(CORNER_GSHAPE, 80)
    want = _jax_box_run(u0, CORNER_MESH, ITERS, bc, impl, "27pt")
    got = ranks8["run", bc, impl]
    assert all(g is None for g in got[1:])
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_27pt_multi_on_8_ranks_equals_jax_bitwise(ranks8, bc):
    """Width-2 ghosts on mesh (2, 2, 2): a 2x2x2 corner block crosses
    three links; two exchanges of two steps each."""
    u0 = cases.field(CORNER_GSHAPE, 80)
    want = _jax_multi_run(u0, CORNER_MESH, 4, bc, "27pt", 2)
    got = ranks8["multi", bc]
    assert all(g is None for g in got[1:])
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_27pt_wave_on_8_ranks_equals_jax_bitwise(ranks8, bc, dtype):
    """The 27-point wave kernel's faces recomputed from ghosts that cross
    three links at a corner."""
    u0 = cases.field(CORNER_GSHAPE, 80)
    want = _jax_wave_run(u0, CORNER_MESH, ITERS, bc, "27pt", dtype)
    got = ranks8["wave", bc, dtype]
    assert all(g is None for g in got[1:])
    np.testing.assert_array_equal(got[0], want)


def test_width_2_corner_ghosts_cross_three_links(ranks8):
    u0 = cases.field(CORNER_GSHAPE, 80)
    nz, ny, nx = (s // p for s, p in zip(CORNER_GSHAPE, CORNER_MESH))
    np.testing.assert_array_equal(
        ranks8["pad2"][0],
        np.pad(u0, 2, mode="wrap")[:nz + 4, :ny + 4, :nx + 4])


def test_corner_ghost_crosses_three_links(ranks8):
    """On mesh (2, 2, 2) a rank's corner ghost is the cell of the rank
    diagonally across all three axes: three hops of the chain."""
    u0 = cases.field(CORNER_GSHAPE, 80)
    nz, ny, nx = (s // p for s, p in zip(CORNER_GSHAPE, CORNER_MESH))
    pads = ranks8["pad"]
    assert pads[0].shape == (nz + 2, ny + 2, nx + 2)
    assert pads[0][0, 0, 0] == u0[-1, -1, -1]  # the periodic wrap of rank 7
    assert pads[0][-1, -1, -1] == u0[nz, ny, nx]  # rank 7's first cell
    assert pads[7][-1, -1, -1] == u0[0, 0, 0]
    np.testing.assert_array_equal(
        pads[0], np.pad(u0, 1, mode="wrap")[:nz + 2, :ny + 2, :nx + 2])


@pytest.mark.parametrize("impl", list(JAX_IMPL))
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("stencil", list(BOX_LAYOUTS))
def test_box_world_of_one_equals_jax_bitwise(stencil, bc, impl):
    """The box stencils on a mesh of one rank (what a single card runs):
    every axis of the chain wraps onto the own rank."""
    gshape = {"9pt": (8, 128), "27pt": (4, 8, 128)}[stencil]
    u0 = cases.field(gshape, 90)
    want = _jax_box_run(u0, (1,) * len(gshape), ITERS, bc, impl, stencil)
    dec = Decomposition(
        make_cart_mesh(len(gshape), periodic=bc == "periodic"), gshape
    )
    got = pdist.run_distributed(dec.scatter(u0), dec, ITERS, bc=bc,
                                impl=impl, stencil=stencil)
    np.testing.assert_array_equal(dec.gather(got), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("name", list(MULTI_LAYOUTS))
def test_wave_world_of_one_equals_jax(name, bc, dtype):
    """``wave`` on a mesh of one rank (what a single card runs): the
    ghosts are the own opposite edges; the module docstring's
    contract."""
    gshape = {"star1": (1024,), "star2": (8, 128), "star3": (4, 8, 128),
              "9pt": (8, 128), "27pt": (4, 8, 128)}[name]
    u0 = cases.field(gshape, 150)
    want = _jax_wave_run(u0, (1,) * len(gshape), ITERS, bc,
                         _multi_stencil(name), dtype)
    dec = Decomposition(
        make_cart_mesh(len(gshape), periodic=bc == "periodic"), gshape
    )
    block = dec.scatter(u0, "cpu", DTYPES[dtype])
    keep = block.clone()
    got = pdist.run_distributed(block, dec, ITERS, bc=bc, impl="wave",
                                stencil=_multi_stencil(name))
    assert_wave_equals_jax(dec.gather(got), want, name, dtype,
                           gshape[-1], ITERS)
    assert (block == keep).all()  # the input block is only read


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("name", list(MULTI_LAYOUTS))
def test_multi_world_of_one_equals_jax_bitwise(name, bc):
    """``multi`` on a mesh of one rank: every axis' width-t exchange
    wraps onto the own rank (no process group: the own edges are the
    ghosts)."""
    gshape = {"star1": (1024,), "star2": (8, 128), "star3": (4, 8, 128),
              "9pt": (8, 128), "27pt": (4, 8, 128)}[name]
    u0 = cases.field(gshape, 120)
    want = _jax_multi_run(u0, (1,) * len(gshape), 6, bc,
                          _multi_stencil(name), 3)
    dec = Decomposition(
        make_cart_mesh(len(gshape), periodic=bc == "periodic"), gshape
    )
    block = dec.scatter(u0)
    keep = block.clone()
    got = pdist.run_distributed(block, dec, 6, bc=bc, impl="multi",
                                stencil=_multi_stencil(name), t_steps=3)
    np.testing.assert_array_equal(dec.gather(got), want)
    assert (block == keep).all()  # the input block is only read


def test_multi_library_refuses_what_jax_refuses():
    cart = make_cart_mesh(2, shape=(2, 2), world=4, rank=0)
    jcart = jmake_cart_mesh(2, backend="cpu-sim", shape=(2, 2))
    dec = Decomposition(cart, (16, 16))
    jdec = JDecomposition(jcart, (16, 16))
    import torch

    with pytest.raises(ValueError) as port:
        pdist.run_distributed(torch.zeros(8, 8), dec, 6, impl="multi",
                              t_steps=4)
    with pytest.raises(ValueError) as ref:
        jdist.run_distributed(jdec.scatter(jnp.zeros((16, 16))), jdec, 6,
                              impl="multi", t_steps=4)
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="t_steps must be >= 1"):
        pdist.make_local_step(cart, "dirichlet", "multi", t_steps=0)
    step = pdist.make_local_step(cart, "dirichlet", "multi", t_steps=9)
    with pytest.raises(ValueError, match=r"local block \(8, 8\) smaller "
                       "than halo width t_steps=9"):
        step(torch.zeros(8, 8))
    with pytest.raises(ValueError, match="pack='kernel' needs a 3D mesh"):
        pdist.make_local_step(cart, "dirichlet", "multi", pack="kernel")


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
    rows = [ranks["bench"], ranks["bench-conv"], ranks["bench-9pt"],
            ranks["bench-multi"]]
    for per_rank in rows:
        assert all(r is None for r in per_rank[1:])
    row, conv, box, multi = (per_rank[0] for per_rank in rows)
    for r in (row, conv, box, multi):
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
    assert (box["workload"], box["impl"]) == ("stencil2d-9pt-dist",
                                              "overlap")
    # the width-1 halo model for multi rows too (as JAX's): the same
    # bytes per iteration, t-fold fewer messages
    assert (multi["workload"], multi["impl"], multi["t_steps"]) == (
        "stencil2d-dist", "multi", 2)


def test_wave_row_passes_the_jax_row_schema(ranks):
    """A ``--mesh 2,2 --impl wave`` row: JAX's identity fields, no chunk
    (the kernels choose their own on a mesh), the width-1 halo model."""
    per_rank = ranks["bench-wave"]
    assert all(r is None for r in per_rank[1:])
    row = per_rank[0]
    errors, warnings = validate_row(json.loads(emit_jsonl(row)))
    assert errors == [] and warnings == []
    assert (row["workload"], row["impl"], row["bc"], row["mesh"],
            row["local_size"], row["pack"], row["verified"]) == (
        "stencil2d-dist", "wave", "periodic", [2, 2], [32, 32], "fused",
        True)
    assert "chunk" not in row
    assert row["halo_bytes_per_chip_per_iter"] == 2 * 2 * 32 * 4


DRIVER = [
    (1, 4096, (4,), "block", "fused", "dirichlet"),
    (2, 256, (2, 2), "torch", "fused", "periodic"),
    (2, 256, (2, 2), "overlap", "fused", "dirichlet"),
    (3, 128, (2, 2, 1), "block", "kernel", "periodic"),
    (3, 128, (2, 2, 1), "stream", "fused", "dirichlet"),
    (1, 4096, (4,), "wave", "fused", "periodic"),
    (2, 256, (2, 2), "wave", "fused", "dirichlet"),
    (3, 128, (2, 2, 1), "wave", "fused", "periodic"),
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
        impl=DRIVER_IMPL[impl], backend="cpu-sim",
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


@pytest.mark.parametrize("points,size,mesh,bc", [
    (0, 256, (2, 2), "periodic"),
    (27, 32, (2, 2, 1), "dirichlet"),
])
def test_multi_driver_dump_equals_jax_driver(tmp_path, points, size, mesh,
                                             bc):
    """``--impl multi --t-steps 2 --iters 4`` through both drivers from
    one ``--load`` file: bitwise dumps, the port's row verified (its
    verify iterations rounded up to a multiple of t)."""
    dim = len(mesh)
    load = tmp_path / "u0.npy"
    np.save(load, cases.field((size,) * dim, 130 + dim))
    common = dict(dim=dim, points=points, size=size, iters=4, t_steps=2,
                  bc=bc, mesh=mesh, load=str(load), warmup=1, reps=1)
    jstencil.run_distributed_bench(jstencil.StencilConfig(
        impl="multi", backend="cpu-sim", dump=str(tmp_path / "a.npy"),
        **common,
    ))
    rec = pstencil.run_distributed_bench(pstencil.StencilConfig(
        impl="multi", backend="cpu", verify=True, verify_iters=3,
        dump=str(tmp_path / "b.npy"), dist_timeout=240, **common,
    ))
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"),
                                  np.load(tmp_path / "a.npy"))
    assert (rec["impl"], rec["t_steps"], rec["mesh"], rec["verified"]) == (
        "multi", 2, list(mesh), True)


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
      "partitioned", "--halo-parts", "0"], "--halo-parts must be >= 1"),
    (["--dim", "2", "--size", "64", "--mesh", "4"], "has 1 axes, --dim is 2"),
    (["--dim", "2", "--size", "64", "--mesh", "2,0"], "positive sizes"),
    (["--dim", "3", "--size", "16", "--mesh", "2,2,1", "--impl", "wave",
      "--chunk", "4"], "--chunk is a single-device tuning knob"),
    (["--dim", "3", "--size", "16", "--pack", "kernel"],
     "--pack applies to a 3D mesh run"),
    (["--points", "9", "--dim", "2", "--size", "64", "--mesh", "2,2",
      "--impl", "wave", "--chunk", "8"],
     "--chunk is a single-device tuning knob"),
    (["--dim", "3", "--size", "16", "--mesh", "2,2,1", "--impl", "wave",
      "--pack", "kernel"], "pack='kernel' needs a 3D mesh and "
     "impl=overlap|block|stream"),
    (["--dim", "2", "--size", "64", "--mesh", "2,2", "--impl", "wave",
      "--chunk", "8"], "--chunk is a single-device tuning knob"),
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
        ({"stencil": "27pt"}, "stencil='27pt' needs a 3D mesh, got 2D"),
        ({"halo_wire": "int8"}, "halo_wire must be a floating dtype"),
        ({"halo_width": 2}, r"unknown kwargs .*\['halo_width'\]"),
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


@pytest.mark.parametrize("points,size,mesh,impl,bc", [
    (9, 256, (2, 2), "block", "periodic"),
    (27, 128, (2, 2, 1), "stream", "dirichlet"),
    (9, 256, (2, 2), "wave", "periodic"),
    (27, 128, (2, 2, 1), "wave", "dirichlet"),
])
def test_box_driver_dump_equals_jax_driver(tmp_path, points, size, mesh,
                                           impl, bc):
    """``run_distributed_bench`` of both packages with ``points`` from one
    ``--load`` file: the port starts its own 4 ranks."""
    dim = len(mesh)
    load = tmp_path / "u0.npy"
    np.save(load, cases.field((size,) * dim, 100 + dim))
    common = dict(dim=dim, points=points, size=size, iters=2, bc=bc,
                  mesh=mesh, load=str(load), warmup=1, reps=1)
    jstencil.run_distributed_bench(jstencil.StencilConfig(
        impl=DRIVER_IMPL[impl], backend="cpu-sim",
        dump=str(tmp_path / "a.npy"), **common,
    ))
    rec = pstencil.run_distributed_bench(pstencil.StencilConfig(
        impl=impl, backend="cpu", verify=True, verify_iters=3,
        dump=str(tmp_path / "b.npy"), dist_timeout=240, **common,
    ))
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"),
                                  np.load(tmp_path / "a.npy"))
    assert rec["workload"] == f"stencil{dim}d-{points}pt-dist"
    assert rec["verified"] and rec["impl"] == impl


def test_box_library_refuses_what_jax_refuses():
    """The same messages where JAX has the case; the port's wording for
    the arms it has no box form of and its own pack name."""
    cart2 = make_cart_mesh(2, shape=(2, 2), world=4, rank=0)
    cart3 = make_cart_mesh(3, shape=(2, 2, 1), world=4, rank=0)
    jcart3 = jmake_cart_mesh(3, backend="cpu-sim", shape=(2, 2, 1))
    with pytest.raises(ValueError) as port:
        pdist.make_local_step(cart3, "dirichlet", "overlap", stencil="9pt")
    with pytest.raises(ValueError) as ref:
        jdist.make_local_step(jcart3, "dirichlet", "overlap", stencil="9pt")
    assert str(port.value) == str(ref.value)
    for cart, impl, kwargs, message in [
        (cart2, "overlap", {"stencil": "5pt"}, "unknown stencil '5pt'"),
        (cart2, "wave", {"stencil": "9pt", "rows_per_chunk": 8},
         "unknown kwargs for stencil='9pt' impl='wave'"),
        (cart3, "wave", {"stencil": "27pt", "pack": "kernel"},
         "pack='kernel' needs a 3D mesh and impl="),
        (cart3, "partitioned", {"stencil": "27pt"},
         "stencil='27pt' supports impl='torch'|'overlap'|'block'|'stream'"),
        (cart3, "block", {"stencil": "27pt", "pack": "kernel"},
         "pack='kernel' does not apply to the box stencils"),
        (cart2, "overlap", {"stencil": "9pt", "halo_width": 2},
         r"unknown kwargs for stencil='9pt' impl='overlap': \['halo_width'"),
    ]:
        with pytest.raises(ValueError, match=message):
            pdist.make_local_step(cart, "dirichlet", impl, **kwargs)


def test_wave_library_refuses_what_jax_refuses():
    """JAX's messages where both have the case: ``rows_per_chunk`` on the
    3D wave, unknown options; the box wave takes no ``rows_per_chunk``."""
    cart3 = make_cart_mesh(3, shape=(2, 2, 2), world=8, rank=0)
    jcart3 = jmake_cart_mesh(3, backend="cpu-sim", shape=(2, 2, 2))
    cart2 = make_cart_mesh(2, shape=(2, 2), world=4, rank=0)
    jcart2 = jmake_cart_mesh(2, backend="cpu-sim", shape=(2, 2))
    for (cart, jcart), kwargs in [
        ((cart3, jcart3), {"rows_per_chunk": 8}),
        ((cart3, jcart3), {"stencil": "27pt", "rows_per_chunk": 8}),
        ((cart2, jcart2), {"stencil": "9pt", "rows_per_chunk": 8}),
    ]:
        with pytest.raises(ValueError) as port:
            pdist.make_local_step(cart, "dirichlet", "wave", **kwargs)
        with pytest.raises(ValueError) as ref:
            jdist.make_local_step(jcart, "dirichlet", "pallas-wave",
                                  **kwargs)
        assert str(port.value) == str(ref.value).replace(
            "pallas-wave", "wave")
    with pytest.raises(ValueError, match="unknown kwargs for impl='wave'"):
        pdist.make_local_step(cart2, "dirichlet", "wave", bogus=1)
    # the 1D and 2D star take it: their ghost-fed kernel's ring blocks
    pdist.make_local_step(cart2, "dirichlet", "wave", rows_per_chunk=8)


def test_box_stencils_from_padded_equal_jax():
    """Float32 and bfloat16 (the field's dtype, with 1/26 rounded to
    it): bitwise."""
    import torch

    for jfn, pfn, shape in (
        (jdist.stencil9_from_padded, pdist.stencil9_from_padded, (6, 9)),
        (jdist.stencil27_from_padded, pdist.stencil27_from_padded,
         (5, 6, 9)),
    ):
        p = cases.field(shape, 51)
        for dtype, jdt in (("float32", jnp.float32),
                           ("bfloat16", jnp.bfloat16)):
            want = jfn(jnp.asarray(p).astype(jdt))
            got = pfn(torch.from_numpy(p).to(DTYPES[dtype]))
            np.testing.assert_array_equal(
                to_numpy_field(got), np.asarray(want.astype(jnp.float32)))
        with pytest.raises(ValueError, match="stencil needs a"):
            pfn(torch.zeros((4,) * (len(shape) - 1)))


def test_stencil_from_padded_and_dtype_constant_equal_jax():
    p = cases.field((6, 7, 9), 50)
    import torch

    for dtype, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        want = jdist.stencil_from_padded(jnp.asarray(p).astype(jdt))
        got = pdist.stencil_from_padded(torch.from_numpy(p).to(DTYPES[dtype]))
        np.testing.assert_array_equal(
            to_numpy_field(got), np.asarray(want.astype(jnp.float32)))
