"""The port's ``overlap`` subcommand (C9 verification from a trace) held
against the JAX package's ``analyze_overlap`` / ``audit_fused``, on the
CPU.

- The interval logic (``bench/overlap.py`` ``overlapping``) on fixed
  synthetic events: disjoint, nested, partly overlapping, touching, none.
- On 4 gloo ranks, started once for this file (``torch_overlap_cases``):
  the P2P ops a step (``n_permutes``) of every exchange arm, held to
  JAX's count of collective-permutes where the two mean the same (a
  periodic mesh whose every axis has two ranks or more: JAX counts one
  permute a direction an axis, the port a rank's sends, each paired with
  its receive); ``scheduled_overlap`` is None off the card, as JAX's is
  off the TPU; and the fused audit's one exchange round a K-step window.
  No test here asserts that two measured intervals overlap.
- The CLI: JAX's arguments, defaults and errors; ``--topology`` refused.
"""

import dataclasses
import json

import numpy as np
import pytest

import torch_mesh_cases as mcases
import torch_overlap_cases as ocases
from tpu_comm import cli as jcli
from tpu_comm.bench import overlap as joverlap
from tpu_comm.domain import Decomposition as JDecomposition
from tpu_comm.topo import make_cart_mesh as jmake_cart_mesh
from tpu_comm_torch import cli
from tpu_comm_torch.bench import overlap as poverlap
from tpu_comm_torch.comm import launch

E = poverlap.Event
NCCL = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"
BLOCK = "void jacobi3d_block_kernel<float>(float const*, float*, int, int, int, int)"
ADD = "void at::native::vectorized_elementwise_kernel<4, ...>(int, ...)"

#: synthetic device traces -> (ops, port kernels) intersecting an NCCL
#: kernel (microseconds; an interval is [ts, ts + dur))
SYNTHETIC = {
    "none": ([E(BLOCK, "kernel", 0, 10), E(ADD, "kernel", 20, 5)], (0, 0)),
    "disjoint": ([E(NCCL, "kernel", 0, 10), E(BLOCK, "kernel", 11, 10),
                  E(ADD, "kernel", 30, 1)], (0, 0)),
    "touching": ([E(NCCL, "kernel", 10, 10), E(BLOCK, "kernel", 0, 10),
                  E(ADD, "kernel", 20, 3)], (0, 0)),
    "nested": ([E(NCCL, "kernel", 0, 100), E(BLOCK, "kernel", 10, 20),
                E(ADD, "kernel", 40, 5)], (2, 1)),
    "nccl-nested": ([E(BLOCK, "kernel", 0, 100),
                     E(NCCL, "kernel", 10, 5)], (1, 1)),
    "partial": ([E(NCCL, "kernel", 10, 10), E(BLOCK, "kernel", 15, 10),
                 E(ADD, "kernel", 5, 6)], (2, 1)),
    "two-transfers": ([E(NCCL, "kernel", 0, 10), E(NCCL, "kernel", 50, 10),
                       E(BLOCK, "kernel", 5, 50),
                       E("Memcpy DtoD", "gpu_memcpy", 52, 2),
                       E("Memset", "gpu_memset", 70, 2)], (2, 1)),
    "host-only": ([E(NCCL, "kernel", 0, 10),
                   E("c10d::send", "cpu_op", 0, 10),
                   E("cudaLaunchKernel", "cuda_runtime", 2, 1)], (0, 0)),
}


@pytest.mark.parametrize("name", list(SYNTHETIC))
def test_overlapping_on_synthetic_events(name):
    events, want = SYNTHETIC[name]
    assert poverlap.overlapping(events) == want


@pytest.mark.parametrize("a,b,want", [
    ((0, 10), (10, 5), False), ((0, 10), (9, 5), True),
    ((5, 1), (0, 10), True), ((0, 0), (0, 10), False),
    ((3, 0), (0, 10), True), ((0, 10), (20, 1), False),
])
def test_intersects_is_symmetric_and_open(a, b, want):
    x, y = E("a", "kernel", *a), E("b", "kernel", *b)
    assert poverlap.intersects(x, y) is want
    assert poverlap.intersects(y, x) is want


def test_port_kernels_are_read_from_the_sources():
    names = poverlap.port_kernel_names()
    assert {"jacobi3d_block_kernel", "pack_faces_kernel", "wave2d_kernel",
            "multi2d_kernel", "membw_dma"} <= names
    assert poverlap.is_port_kernel(E(BLOCK, "kernel", 0, 1))
    assert not poverlap.is_port_kernel(E(ADD, "kernel", 0, 1))
    assert not poverlap.is_port_kernel(E(NCCL, "kernel", 0, 1))
    assert not poverlap.is_port_kernel(E(BLOCK, "cpu_op", 0, 1))


def test_read_events_keeps_complete_events(tmp_path):
    """``bench/trace.py`` ``read_events``, which the audit reads."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "k", "cat": "kernel", "ts": 1.5, "dur": 2},
        {"ph": "i", "name": "instant", "ts": 3},
        {"ph": "X", "name": "h", "ts": 4},
    ]}))
    assert poverlap.read_events(path) == [E("k", "kernel", 1.5, 2.0),
                                          E("h", "", 4.0, 0.0)]


def test_report_keeps_jax_fields():
    assert [f.name for f in dataclasses.fields(poverlap.OverlapReport)] == [
        f.name for f in dataclasses.fields(joverlap.OverlapReport)]


@pytest.mark.parametrize("size,mesh", [(64, (2, 2)), (10, (4,)),
                                       (7, (2, 2, 1)), (130, (4, 2))])
def test_round_global_shape_equals_jax(size, mesh):
    assert poverlap.round_global_shape(size, mesh) == \
        joverlap.round_global_shape(size, mesh)


# ------------------------------------------------------ on 4 gloo ranks

#: (dim, mesh): periodic meshes where a rank's sends equal JAX's permutes
MESHES = {1: (4,), 2: (2, 2)}
#: the arms and their options
ARMS = {"torch": (), "overlap": (), "partitioned": (("halo_parts", 3),)}
JAX_ARM = {"torch": "lax", "overlap": "overlap", "partitioned": "partitioned"}
#: fused audits: (dim, impl, fuse_steps, halo_width)
AUDITS = [(2, "overlap", 4, None), (2, "torch", 4, 2), (2, "overlap", 4, 4),
          (1, "overlap", 6, 3), (2, "partitioned", 2, None)]


@pytest.fixture(scope="module")
def ranks():
    todo = {}
    for dim, mesh in MESHES.items():
        for impl, opts in ARMS.items():
            for bc in ("periodic", "dirichlet"):
                todo["analyze", dim, impl, bc] = ("analyze", {
                    "mesh": mesh, "bc": bc, "impl": impl, "opts": opts})
    for dim, impl, fuse, hw in AUDITS:
        todo["audit", dim, impl, fuse, hw] = ("audit", {
            "mesh": MESHES[dim], "bc": "periodic", "impl": impl,
            "fuse_steps": fuse, "halo_width": hw, "opts": ARMS[impl]})
    for pack in ("fused", "kernel"):
        for bc in ("periodic", "dirichlet"):
            todo["roundtrip", pack, bc] = ("roundtrip", {
                "u0": mcases.field((8, 12, 16), 5), "mesh": (2, 2, 1),
                "bc": bc, "pack": pack})
    with pytest.MonkeyPatch.context() as env:
        env.setenv("OMP_NUM_THREADS", "1")
        return launch.run_ranks(ocases.run_cases, 4, "gloo", (todo,),
                                timeout_s=300)


def _jax_dec(dim, bc):
    cart = jmake_cart_mesh(dim, backend="cpu-sim", shape=MESHES[dim],
                           periodic=bc == "periodic")
    return JDecomposition(cart,
                          joverlap.round_global_shape(64, cart.shape))


@pytest.mark.parametrize("impl", list(ARMS))
@pytest.mark.parametrize("dim", list(MESHES))
def test_p2p_ops_a_step_equal_jax_permutes(ranks, dim, impl):
    reports = ranks["analyze", dim, impl, "periodic"]
    got = reports[0]
    # on a periodic mesh every rank sends the same
    assert all(r == got for r in reports)
    want = joverlap.analyze_overlap(_jax_dec(dim, "periodic"),
                                    bc="periodic", impl=JAX_ARM[impl],
                                    opts=ARMS[impl])
    assert got["n_permutes"] == want.n_permutes > 0
    assert set(got) == set(want.to_dict())
    assert (got["platform"], got["impl"]) == ("cpu", impl)
    # off the card there is no device schedule: no NCCL kernel, no
    # interval, no verdict (JAX's is None off the TPU too)
    assert got["scheduled_overlap"] is None is want.scheduled_overlap
    assert (got["n_async_pairs"], got["fused_ops_between"],
            got["kernels_between"]) == (0, 0, 0)


@pytest.mark.parametrize("impl", list(ARMS))
@pytest.mark.parametrize("dim", list(MESHES))
def test_dirichlet_rank_0_sends_to_its_neighbours_only(ranks, dim, impl):
    """An open edge posts no transfer: rank 0, at the low corner, sends
    one face an axis (JAX's permutes still count both directions)."""
    got = ranks["analyze", dim, impl, "dirichlet"][0]
    parts = dict(ARMS[impl]).get("halo_parts", 1) if dim > 1 else 1
    assert got["n_permutes"] == dim * parts
    assert got["scheduled_overlap"] is None


@pytest.mark.parametrize("dim,impl,fuse,hw", AUDITS)
def test_fused_audit_counts_and_windows(ranks, dim, impl, fuse, hw):
    doc = ranks["audit", dim, impl, fuse, hw][0]
    want = joverlap.audit_fused(_jax_dec(dim, "periodic"), bc="periodic",
                                impl=JAX_ARM[impl], fuse_steps=fuse,
                                opts=ARMS[impl], halo_width=hw)
    assert doc["n_permutes"] == want["n_permutes"] > 0
    assert (doc["impl"], doc["platform"], doc["fuse_steps"]) == (
        impl, "cpu", fuse)
    # a CPU dispatch is eager steps: no graph to audit
    assert doc["exchange_in_graph"] is None
    assert doc["n_executables"] is None
    assert doc["host_roundtrips_between_steps"] is None
    if hw is None:
        assert "halo_width" not in doc
        return
    for key in ("halo_width", "windows", "permutes_per_window",
                "permutes_per_step_reference", "one_exchange_per_window"):
        assert doc[key] == want[key], key
    assert doc["one_exchange_per_window"] is True


@pytest.mark.parametrize("bc", ["periodic", "dirichlet"])
@pytest.mark.parametrize("pack", ["fused", "kernel"])
def test_pack_exchange_unpack_round_trip(ranks, pack, bc):
    """Every rank's faces packed, exchanged and unpacked into its
    zero-padded block equal ``assemble_padded`` of the ghosts, and the
    padded block's faces are the neighbours' cells (periodic wrap, or
    zeros at an open edge); edges and corners stay zero."""
    u0 = mcases.field((8, 12, 16), 5)
    mode = "wrap" if bc == "periodic" else "constant"
    g = np.pad(u0, 1, mode=mode)
    for rank, (got, equal) in enumerate(ranks["roundtrip", pack, bc]):
        assert equal, rank
        # mesh (2, 2, 1): local blocks (4, 6, 16), rank = 2 * c0 + c1
        c0, c1 = divmod(rank, 2)
        want = g[c0 * 4:c0 * 4 + 6, c1 * 6:c1 * 6 + 8, :].copy()
        # edges and corners of the padded block stay zero
        for a in range(3):
            for b in range(a + 1, 3):
                for i in (0, -1):
                    for j in (0, -1):
                        idx = [slice(None)] * 3
                        idx[a], idx[b] = i, j
                        want[tuple(idx)] = 0
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ CLI

def test_cli_defaults_follow_jax():
    args = cli.build_parser().parse_args(["overlap"])
    jargs = jcli.build_parser().parse_args(["overlap"])
    for name in ("dim", "size", "mesh", "bc", "impl", "fuse_steps",
                 "halo_parts", "halo_width", "topology"):
        assert getattr(args, name) == getattr(jargs, name), name


def test_cli_prints_the_report_on_cpu(capsys, monkeypatch):
    # one thread per rank: the four ranks run beside the other test
    # workers
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert cli.main(["overlap", "--backend", "cpu", "--dim", "2", "--mesh",
                     "2,2", "--bc", "periodic", "--impl", "partitioned",
                     "--halo-parts", "2"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(doc) == {f.name for f in
                        dataclasses.fields(joverlap.OverlapReport)}
    assert (doc["n_permutes"], doc["scheduled_overlap"]) == (8, None)


@pytest.mark.parametrize("argv,message", [
    (["--topology", "v5e:2x2"], "--topology"),
    (["--impl", "lax"], "--impl lax is the JAX package's name; the port "
     "calls this arm 'torch'"),
    (["--impl", "overlap", "--halo-parts", "2"],
     "--halo-parts applies to --impl partitioned"),
    (["--halo-width", "2"], "--halo-width audits the fused deep-halo "
     "program; pass --fuse-steps N"),
    (["--dim", "2", "--mesh", "2,2,1"], "--mesh must have 2 comma-"
     "separated entries for --dim 2, got '2,2,1'"),
    (["--mesh", "2,x,1"], "--mesh must be a comma list of integers"),
    (["--impl", "block"], "--impl must be one of"),
])
def test_cli_refusals_exit_2(capsys, argv, message):
    assert cli.main(["overlap", "--backend", "cpu", *argv]) == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--impl", "overlap", "--halo-parts", "2"],
    ["--halo-width", "2"],
    ["--dim", "2", "--mesh", "2,2,1"],
])
def test_cli_refusals_are_jax_refusals(capsys, argv):
    """Each argument error the port shares with JAX exits 2 in both."""
    assert jcli.main(["overlap", "--backend", "cpu-sim", *argv]) == 2
    capsys.readouterr()
