"""The port's rank mesh, pattern tables and rank launcher, held against
the JAX package on the CPU.

``CartMesh`` is one rank's view of the mesh the JAX package builds over
cpu-sim devices: the same shift tables, rank ``r`` at the coordinate of
device ``r`` (row-major id order), and the neighbour a +/-1 shift sends
to. The launcher tests start real ranks (``gloo``) and must end, failed,
within their time limit.
"""

import time

import numpy as np
import pytest

import torch_mesh_cases as cases
from tpu_comm import topo as jtopo
from tpu_comm.comm import patterns as jpatterns
from tpu_comm_torch import topo as ptopo
from tpu_comm_torch.comm import launch
from tpu_comm_torch.comm import patterns as ppatterns

MESHES = [(1,), (4,), (8,), (2, 2), (4, 2), (1, 1), (2, 2, 1), (2, 2, 2),
          (1, 1, 1)]


@pytest.mark.parametrize("ndims", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12, 24, 30, 64, 97])
def test_factor_mesh_equals_jax(n, ndims):
    got = ptopo.factor_mesh(n, ndims)
    assert got == jtopo.factor_mesh(n, ndims)
    assert int(np.prod(got)) == n and len(got) == ndims


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shift", [+1, -1])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_shift_pairs_equal_jax(n, shift, periodic):
    got = ppatterns.shift_pairs(n, shift, periodic)
    assert got == jpatterns.shift_pairs(n, shift, periodic)
    if n == 1:
        # a periodic axis of one rank receives its own opposite edge
        assert got == ([(0, 0)] if periodic else [])


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_cart_mesh_matches_jax_cpu_sim_mesh(shape, periodic):
    """Same shift tables, and rank r sits where the JAX mesh puts device
    r; ``neighbor`` is this rank's row of the table."""
    nd = len(shape)
    jcart = jtopo.make_cart_mesh(nd, backend="cpu-sim", shape=shape,
                                 periodic=periodic)
    ids = np.vectorize(lambda d: d.id)(jcart.mesh.devices)
    base = int(ids.min())
    world = int(np.prod(shape))
    for rank in range(world):
        cart = ptopo.make_cart_mesh(nd, shape=shape, periodic=periodic,
                                    world=world, rank=rank)
        assert cart.shape == jcart.shape
        assert cart.axis_names == jcart.axis_names
        assert cart.periodic == jcart.periodic and cart.plan_id is None
        assert int(ids[cart.coords]) - base == rank
        assert cart.rank_at(cart.coords) == rank
        for i, name in enumerate(cart.axis_names):
            assert cart.axis_size(name) == jcart.axis_size(name)
            assert cart.is_periodic(name) == jcart.is_periodic(name)
            for shift in (+1, -1):
                table = cart.shift_perm(name, shift)
                assert table == jcart.shift_perm(name, shift)
                dst = dict(table).get(cart.coords[i])
                want = None
                if dst is not None:
                    c = list(cart.coords)
                    c[i] = dst
                    want = int(ids[tuple(c)]) - base
                assert cart.neighbor(name, shift) == want


def test_make_cart_mesh_defaults_and_errors():
    cart = ptopo.make_cart_mesh(2, world=8, rank=5)
    assert cart.shape == ptopo.factor_mesh(8, 2) == (4, 2)
    assert cart.coords == (2, 1) and cart.world == 8
    assert [cart.coords_of(r) for r in (0, 1, 2, 7)] == [
        (0, 0), (0, 1), (1, 0), (3, 1)]
    lone = ptopo.make_cart_mesh(3)  # no process group: a world of one
    assert lone.shape == (1, 1, 1) and lone.rank == 0
    assert lone.neighbor("x", +1) is None
    wrap = ptopo.make_cart_mesh(1, periodic=True)
    assert wrap.neighbor("x", +1) == wrap.neighbor("x", -1) == 0
    with pytest.raises(RuntimeError, match="needs exactly 4"):
        ptopo.make_cart_mesh(2, shape=(2, 2), world=8, rank=0)
    with pytest.raises(ValueError, match="has 1 axes"):
        ptopo.make_cart_mesh(2, shape=(4,), world=4, rank=0)
    with pytest.raises(ValueError, match="len\\(periodic\\)"):
        ptopo.make_cart_mesh(2, shape=(2, 2), world=4, rank=0,
                             periodic=(True,))
    with pytest.raises(ValueError, match="outside mesh"):
        ptopo.CartMesh((2, 2), ("x", "y"), rank=4)


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("local,mesh", [
    ((1024,), (4,)), ((1024,), (1,)), ((8, 128), (2, 2)),
    ((8, 128), (1, 4)), ((4, 8, 128), (2, 2, 1)), ((4, 8, 128), (2, 2, 2)),
    ((512, 512, 512), (1, 1, 1)),
])
def test_halo_bytes_per_iter_equals_jax(local, mesh, itemsize, width):
    from tpu_comm_torch.comm.halo import halo_bytes_per_iter

    cart = ptopo.make_cart_mesh(len(mesh), shape=mesh,
                                world=int(np.prod(mesh)), rank=0)
    want = jpatterns.halo_bytes_per_iter_model(local, mesh, itemsize, width)
    assert halo_bytes_per_iter(local, cart, itemsize, width) == want
    assert ppatterns.halo_bytes_per_iter_model(
        local, mesh, itemsize, width) == want


def test_backend_for_device_type():
    assert launch.backend_for("cuda") == "nccl"
    assert launch.backend_for("cpu") == "gloo"


def test_run_ranks_returns_rank0_result():
    got = launch.run_ranks(
        cases.run_cases, 2, "gloo",
        ({"sg": ("scatter_gather",
                 {"u0": cases.field((8,), 1), "mesh": (2,)})},),
        timeout_s=120,
    )
    (c0, o0, b0, g0), (c1, o1, b1, g1) = got["sg"]
    assert (c0, o0, c1, o1) == ((0,), (0,), (1,), (4,))
    np.testing.assert_array_equal(g0, cases.field((8,), 1))
    assert g1 is None


def test_a_failing_rank_fails_the_run_within_its_limit():
    """Rank 2 raises while the others wait in a barrier: the parent names
    the rank and its error, kills the rest, and returns long before the
    group's own timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match="rank 2 failed: ValueError: injected"):
        launch.run_ranks(cases.fail_on_rank, 4, "gloo", (2,), timeout_s=120)
    assert time.monotonic() - t0 < 90


def test_hanging_ranks_are_killed_at_the_time_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish within"):
        launch.run_ranks(cases.hang_forever, 2, "gloo", timeout_s=6)
    assert time.monotonic() - t0 < 60


def test_process_group_of_one_is_created_and_destroyed():
    import torch
    import torch.distributed as dist

    assert not dist.is_initialized()
    with launch.process_group("gloo", timeout_s=60):
        assert dist.get_world_size() == 1
        t = torch.ones(3)
        dist.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
        with launch.process_group("gloo"):  # joins the one that is up
            assert dist.is_initialized()
        assert dist.is_initialized()
        with pytest.raises(RuntimeError, match="the mesh needs 4"):
            with launch.process_group("gloo", world=4):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_method"):
        with launch.process_group("gloo", world=2):
            pass
