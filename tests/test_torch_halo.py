"""The port's ghost-cell halo exchange held against the JAX package's.

The same seeded global field is decomposed by both packages: JAX runs
``comm.halo`` under ``shard_map`` over cpu-sim devices, the port runs its
``comm.halo`` on 4 ``gloo`` ranks (started once for this file, every case
in that one spawn). Each rank's ghosts and padded blocks must equal, bit
for bit, what the JAX mesh delivers to the device at the same
coordinate. Open edges are zeros; ``pad_halo`` corners arrive through
the chained exchange, ``assemble_padded`` corners are zero.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_mesh_cases as cases
from tpu_comm.comm import halo as jhalo
from tpu_comm.domain import Decomposition as JDecomposition
from tpu_comm.topo import make_cart_mesh as jmake_cart_mesh
from tpu_comm_torch.comm import halo as phalo
from tpu_comm_torch.comm import launch
from tpu_comm_torch.topo import make_cart_mesh

LAYOUTS = {
    1: ((4096,), (4,)),
    2: ((16, 256), (2, 2)),
    3: ((8, 16, 128), (2, 2, 1)),
}
BCS = ("dirichlet", "periodic")


def _jax_per_rank(dim, bc, fn, n_out=1):
    """Run ``fn(block, cart)`` under shard_map on the JAX mesh; returns
    per output a list of the ranks' results (rank = row-major coords)."""
    gshape, mesh = LAYOUTS[dim]
    cart = jmake_cart_mesh(dim, backend="cpu-sim", shape=mesh,
                           periodic=bc == "periodic")
    dec = JDecomposition(cart, gshape)
    spec = dec.spec
    outs = jax.shard_map(
        lambda b: fn(b, cart), mesh=cart.mesh, in_specs=spec,
        out_specs=(spec,) * n_out if n_out > 1 else spec, check_vma=False,
    )(dec.scatter(jnp.asarray(cases.field(gshape, dim))))
    if n_out == 1:
        outs = (outs,)
    per_output = []
    for out in outs:
        out = np.asarray(out)
        local = tuple(s // p for s, p in zip(out.shape, mesh))
        blocks = []
        for rank in range(int(np.prod(mesh))):
            coords = np.unravel_index(rank, mesh)
            blocks.append(out[tuple(
                slice(c * n, (c + 1) * n) for c, n in zip(coords, local)
            )])
        per_output.append(blocks)
    return per_output if n_out > 1 else per_output[0]


@pytest.fixture(scope="module")
def ranks():
    todo = {}
    for dim, (gshape, mesh) in LAYOUTS.items():
        u0 = cases.field(gshape, dim)
        for bc in BCS:
            p = {"u0": u0, "mesh": mesh, "bc": bc}
            for axis in range(dim):
                for width in (1, 2):
                    todo["ghosts", dim, bc, axis, width] = (
                        "ghosts_along", {**p, "axis": axis, "width": width})
            for width in (1, 2):
                todo["pad", dim, bc, width] = ("pad_halo",
                                               {**p, "width": width})
            todo["assemble", dim, bc, None] = ("assemble", p)
            if dim == 3:
                for pack in ("fused", "kernel"):
                    todo["assemble", dim, bc, pack] = (
                        "assemble", {**p, "pack": pack})
    # a block of 2 along x cannot source a width-3 halo
    todo["too-wide"] = ("ghosts_along", {
        "u0": cases.field((8, 4), 0), "mesh": (2, 2), "axis": 1, "width": 3})
    # one thread per rank: four ranks run beside the other test workers
    with pytest.MonkeyPatch.context() as env:
        env.setenv("OMP_NUM_THREADS", "1")
        return launch.run_ranks(cases.run_cases, 4, "gloo", (todo,),
                                timeout_s=240)


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("dim,axis", [(1, 0), (2, 0), (2, 1), (3, 0), (3, 1),
                                      (3, 2)])
def test_ghosts_along_equals_jax(ranks, dim, axis, bc, width):
    want_lo, want_hi = _jax_per_rank(
        dim, bc,
        lambda b, cart: jhalo.ghosts_along(b, cart, cart.axis_names[axis],
                                           axis, width),
        n_out=2,
    )
    mesh = LAYOUTS[dim][1]
    for rank, (lo, hi) in enumerate(ranks["ghosts", dim, bc, axis, width]):
        np.testing.assert_array_equal(lo, want_lo[rank])
        np.testing.assert_array_equal(hi, want_hi[rank])
        coord = np.unravel_index(rank, mesh)[axis]
        if bc == "dirichlet":  # an open edge receives zeros
            if coord == 0:
                assert not lo.any()
            if coord == mesh[axis] - 1:
                assert not hi.any()
        elif mesh[axis] == 1:  # a periodic axis of one wraps onto itself
            assert lo.any() and hi.any()


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_pad_halo_equals_jax_corners_included(ranks, dim, bc, width):
    want = _jax_per_rank(
        dim, bc, lambda b, cart: jhalo.pad_halo(b, cart, width=width)
    )
    gshape, mesh = LAYOUTS[dim]
    for rank, got in enumerate(ranks["pad", dim, bc, width]):
        assert got.shape == tuple(
            s // p + 2 * width for s, p in zip(gshape, mesh)
        )
        np.testing.assert_array_equal(got, want[rank])
    if dim == 2 and bc == "periodic" and width == 1:
        # the corner ghost is the diagonal neighbour's corner cell
        u0 = cases.field(gshape, dim)
        ny, nx = (s // p for s, p in zip(gshape, mesh))
        assert ranks["pad", dim, bc, width][0][0, 0] == u0[-1, -1]
        assert ranks["pad", dim, bc, width][3][-1, -1] == u0[0, 0]
        assert ranks["pad", dim, bc, width][0][-1, -1] == u0[ny, nx]


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("dim,pack", [(1, None), (2, None), (3, None),
                                      (3, "fused"), (3, "kernel")])
def test_assemble_padded_equals_jax(ranks, dim, pack, bc):
    """The parallel exchange (``pack`` None) and, on the 3D mesh, the
    explicit-pack exchange by either pack arm."""
    if pack is None:
        def fn(b, cart):
            return jhalo.assemble_padded(b, jhalo.exchange_ghosts(b, cart))
    else:
        def fn(b, cart):
            return jhalo.assemble_padded(b, jhalo.exchange_ghosts_3d_packed(
                b, cart, pack_impl={"fused": "lax", "kernel": "pallas"}[pack],
                interpret=True,
            ))
    want = _jax_per_rank(dim, bc, fn)
    for rank, got in enumerate(ranks["assemble", dim, bc, pack]):
        np.testing.assert_array_equal(got, want[rank])
        if dim == 2:  # corners of the parallel exchange are zero-filled
            assert got[0, 0] == got[0, -1] == got[-1, 0] == got[-1, -1] == 0


def test_a_halo_wider_than_the_block_is_refused_as_in_jax(ranks):
    jcart = jmake_cart_mesh(2, backend="cpu-sim", shape=(2, 2))
    with pytest.raises(ValueError) as ref:
        jax.shard_map(
            lambda b: jhalo.ghosts_along(b, jcart, "y", 1, 3)[0],
            mesh=jcart.mesh, in_specs=JDecomposition(jcart, (8, 4)).spec,
            out_specs=JDecomposition(jcart, (8, 4)).spec,
        )(jnp.zeros((8, 4)))
    for err in ranks["too-wide"]:
        assert isinstance(err, ValueError) and str(err) == str(ref.value)


def test_world_of_one_needs_no_group():
    """Without a process group a lone rank still gets its ghosts: zeros
    at the open edges, its own opposite edges on a periodic axis."""
    import torch

    block = torch.from_numpy(cases.field((4, 6), 5))
    for periodic in (False, True):
        cart = make_cart_mesh(2, periodic=periodic)
        (a0, lo0, hi0), (a1, lo1, hi1) = phalo.exchange_ghosts(block, cart)
        assert (a0, a1) == (0, 1)
        assert lo0.shape == (1, 6) and lo1.shape == (4, 1)
        if periodic:
            assert torch.equal(lo0, block[-1:]) and torch.equal(hi0, block[:1])
            assert torch.equal(lo1, block[:, -1:])
            assert torch.equal(hi1, block[:, :1])
            want = np.pad(block.numpy(), 1, mode="wrap")
            np.testing.assert_array_equal(
                phalo.pad_halo(block, cart).numpy(), want)
        else:
            assert not (lo0.any() or hi0.any() or lo1.any() or hi1.any())
            np.testing.assert_array_equal(
                phalo.pad_halo(block, cart).numpy(),
                np.pad(block.numpy(), 1))
    with pytest.raises(ValueError, match="needs a 3D block/mesh"):
        phalo.exchange_ghosts_3d_packed(block, make_cart_mesh(2))
