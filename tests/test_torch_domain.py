"""The port's domain decomposition held against the JAX package's.

Both packages start from the same seeded NumPy field. JAX shards it over
cpu-sim devices; the port's ranks (4 ``gloo`` processes, started once for
this file) each slice their own block out of it. Rank r must hold exactly
the block the JAX mesh puts on device r, and ``gather`` must return the
field bit for bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import torch_mesh_cases as cases
from tpu_comm.domain import Decomposition as JDecomposition
from tpu_comm.topo import make_cart_mesh as jmake_cart_mesh
from tpu_comm_torch.comm import launch
from tpu_comm_torch.domain import Decomposition
from tpu_comm_torch.topo import make_cart_mesh

LAYOUTS = {
    "1d": ((4096,), (4,)),
    "2d": ((16, 256), (2, 2)),
    "2d-strip": ((16, 256), (1, 4)),
    "3d": ((8, 16, 128), (2, 2, 1)),
}


@pytest.fixture(scope="module")
def ranks():
    todo = {}
    for name, (gshape, mesh) in LAYOUTS.items():
        for dtype in ("float32", "bfloat16"):
            todo[name, dtype] = ("scatter_gather", {
                "u0": cases.field(gshape, 3), "mesh": mesh, "dtype": dtype,
            })
    # one thread per rank: four ranks run beside the other test workers
    with pytest.MonkeyPatch.context() as env:
        env.setenv("OMP_NUM_THREADS", "1")
        return launch.run_ranks(cases.run_cases, 4, "gloo", (todo,),
                                timeout_s=240)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_scatter_gives_each_rank_the_jax_shard(ranks, name, dtype):
    gshape, mesh = LAYOUTS[name]
    u0 = cases.field(gshape, 3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jcart = jmake_cart_mesh(len(mesh), backend="cpu-sim", shape=mesh)
    jdec = JDecomposition(jcart, gshape)
    sharded = jdec.scatter(jnp.asarray(u0).astype(jdt))
    base = min(d.id for d in jcart.mesh.devices.flat)
    shards = {s.device.id - base: s for s in sharded.addressable_shards}
    for rank, (coords, offset, block, _) in enumerate(ranks[name, dtype]):
        want = np.asarray(shards[rank].data.astype(jnp.float32))
        np.testing.assert_array_equal(block, want)
        assert block.shape == jdec.local_shape
        assert offset == jdec.global_offset(coords)
        assert tuple(s.start or 0 for s in shards[rank].index) == offset


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_gather_returns_the_field_on_rank_0_only(ranks, name, dtype):
    gshape, _ = LAYOUTS[name]
    u0 = cases.field(gshape, 3)
    if dtype == "bfloat16":
        u0 = np.asarray(jnp.asarray(u0).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    gathered = [g for _, _, _, g in ranks[name, dtype]]
    assert gathered[0].dtype == np.float32
    np.testing.assert_array_equal(gathered[0], u0)
    assert all(g is None for g in gathered[1:])


@pytest.mark.parametrize("gshape,mesh", [
    ((4096,), (4,)), ((16, 256), (2, 2)), ((8, 16, 128), (2, 2, 1)),
    ((12, 9), (2, 3)),
])
def test_index_math_equals_jax(gshape, mesh):
    world = int(np.prod(mesh))
    jdec = JDecomposition(
        jmake_cart_mesh(len(mesh), backend="cpu-sim", shape=mesh), gshape
    )
    for rank in range(world):
        cart = make_cart_mesh(len(mesh), shape=mesh, world=world, rank=rank)
        dec = Decomposition(cart, gshape)
        assert dec.local_shape == jdec.local_shape
        assert dec.global_offset(cart.coords) == jdec.global_offset(
            cart.coords
        )


def test_world_of_one_scatters_and_gathers_without_a_group():
    u0 = cases.field((6, 10), 2)
    dec = Decomposition(make_cart_mesh(2), (6, 10))
    block = dec.scatter(u0)
    assert block.is_contiguous() and tuple(block.shape) == (6, 10)
    np.testing.assert_array_equal(dec.gather(block), u0)


def test_decomposition_refuses_what_jax_refuses():
    cart = make_cart_mesh(2, shape=(2, 2), world=4, rank=0)
    jcart = jmake_cart_mesh(2, backend="cpu-sim", shape=(2, 2))
    for gshape in ((16,), (15, 16), (16, 15)):
        with pytest.raises(ValueError) as port:
            Decomposition(cart, gshape)
        with pytest.raises(ValueError) as ref:
            JDecomposition(jcart, gshape)
        assert str(port.value) == str(ref.value)
    dec = Decomposition(cart, (16, 16))
    with pytest.raises(ValueError, match="array shape"):
        dec.scatter(np.zeros((16, 8), np.float32))
    import torch

    with pytest.raises(ValueError, match="block shape"):
        dec.gather(torch.zeros(16, 16))
