"""The port's collectives (``tpu_comm_torch/comm/collectives.py``) held
against the JAX package's, on the CPU.

The same seeded float32 array goes through both packages: JAX shards it
over a 1D cpu-sim mesh of n devices and runs each function inside
``shard_map``; the port splits it over n ``gloo`` ranks (rank i takes
block i, as the shard), started once per world size for this file with
every case in that one spawn (``torch_coll_cases.run_cases``), and over
a world of one in process. Worlds: 4 ranks, 3 (not a power of two: the
tree's last round sends to one rank only), 1.

Contract, in float32 and bfloat16 (both narrowed from the same float32
values, rounding to nearest even):
- bitwise equal to JAX: the ring reduce-scatter, all-gather and
  allreduce (also with a bfloat16 wire and float32 accumulation: the
  ring fixes each chunk's sum order), ``bcast_tree`` and ``bcast_psum``
  at roots 0 and 2 (a masked sum adds only zeros), ``all_gather`` (it
  only moves data);
- ``allreduce``, ``reduce_scatter`` and ``allreduce_mixed`` leave the
  sum order to the library (XLA here, gloo or NCCL there): within the
  tolerance of JAX's own ``_verify_op`` (1e-5 in float32, else 5e-2);
- every function also within that tolerance of the float64 NumPy
  oracle, and none writes into its input.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_coll_cases as cases
from tpu_comm.comm import collectives as jcoll
from tpu_comm.topo import make_cart_mesh as jmake_cart_mesh
from tpu_comm_torch.comm import collectives as pcoll
from tpu_comm_torch.comm import launch

WORLDS = (4, 3, 1)
DTYPES = ("float32", "bfloat16")
JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
#: elements a rank holds: 3 and 4 divide it (the ring splits it n ways)
PER_RANK = 24
WIRE = {"wire_dtype": "bfloat16", "acc_dtype": "float32"}
#: (case id, function, kwargs, bitwise)
FUNCS = [
    ("allreduce", "allreduce", {}, False),
    ("reduce_scatter", "reduce_scatter", {}, False),
    ("all_gather", "all_gather", {}, True),
    ("bcast_psum-root0", "bcast_psum", {"root": 0}, True),
    ("bcast_psum-root2", "bcast_psum", {"root": 2}, True),
    ("bcast_tree-root0", "bcast_tree", {"root": 0}, True),
    ("bcast_tree-root2", "bcast_tree", {"root": 2}, True),
    ("ring_reduce_scatter", "ring_reduce_scatter", {}, True),
    ("ring_reduce_scatter-wire", "ring_reduce_scatter", WIRE, True),
    ("ring_all_gather", "ring_all_gather", {}, True),
    ("ring_allreduce", "ring_allreduce", {}, True),
    ("ring_allreduce-wire", "ring_allreduce", WIRE, True),
    ("allreduce_mixed", "allreduce_mixed", {}, False),
]
CASES = [(f, dtype) for f in FUNCS for dtype in DTYPES]
#: functions run over a group of ranks 1-3 of the 4-rank world (the peers
#: of their hops are group ranks, named by global rank)
SUBGROUP = [("ring_allreduce", {}), ("bcast_tree", {"root": 1}),
            ("bcast_psum", {"root": 2}), ("all_gather", {})]


def host(n: int, seed: int, per: int = PER_RANK) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n * per).astype(
        np.float32)


def _todo(n: int) -> dict:
    todo = {}
    for seed, ((cid, fn, kwargs, _), dtype) in enumerate(CASES):
        todo[cid, dtype] = ("coll", {"host": host(n, seed), "fn": fn,
                                     "kwargs": kwargs, "dtype": dtype})
    if n == 4:
        for fn, kwargs in SUBGROUP:
            todo["subgroup", fn] = ("subgroup", {
                "host": host(3, 50), "fn": fn, "ranks": [1, 2, 3],
                "kwargs": kwargs})
    if n > 1:
        # a leading axis n does not divide
        todo["indivisible"] = ("coll", {
            "host": host(n, 99, per=n + 2), "fn": "ring_reduce_scatter",
            "dtype": "float32"})
    return todo


def run_world(n: int, todo: dict) -> dict:
    """``torch_coll_cases.run_cases(todo)`` on n gloo ranks (a world of
    one in this process)."""
    if n == 1:
        with launch.process_group("gloo", timeout_s=120):
            return cases.run_cases(todo)
    # one thread per rank: the ranks run beside the other test workers
    with pytest.MonkeyPatch.context() as env:
        env.setenv("OMP_NUM_THREADS", "1")
        return launch.run_ranks(cases.run_cases, n, "gloo", (todo,),
                                timeout_s=300)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def world(request):
    n = request.param
    return n, run_world(n, _todo(n))


def jax_shard_run(fn, host_f32: np.ndarray, n: int, dtype: str):
    """``fn(block, axis)`` inside ``shard_map`` over n cpu-sim devices;
    the global result as float32 NumPy."""
    cart = jmake_cart_mesh(1, backend="cpu-sim", n_devices=n, periodic=True)
    (axis,) = cart.axis_names
    x = jax.device_put(jnp.asarray(host_f32).astype(JDTYPES[dtype]),
                       NamedSharding(cart.mesh, P(axis)))
    out = jax.jit(jax.shard_map(lambda b: fn(b, axis), mesh=cart.mesh,
                                in_specs=P(axis), out_specs=P(axis)))(x)
    return np.asarray(out.astype(jnp.float32))


def _jax_kwargs(kwargs: dict) -> dict:
    return {k: (JDTYPES[v] if k.endswith("dtype") else v)
            for k, v in kwargs.items()}


def rounded(host_f32: np.ndarray, dtype: str) -> np.ndarray:
    """The input as the ranks hold it, widened to float64."""
    x = jnp.asarray(host_f32).astype(JDTYPES[dtype]).astype(jnp.float32)
    return np.asarray(x).astype(np.float64)


def oracle(fn: str, kwargs: dict, x: np.ndarray, n: int):
    """The float64 NumPy result of ``fn`` (global, as JAX returns it),
    or None where the root is no rank."""
    blocks = x.reshape(n, -1)
    total = blocks.sum(axis=0)
    if fn in ("allreduce", "ring_allreduce", "allreduce_mixed"):
        return np.tile(total, n)
    if fn in ("reduce_scatter", "ring_reduce_scatter"):
        return total
    if fn in ("all_gather", "ring_all_gather"):
        return np.tile(x, n)
    root = kwargs["root"]
    if root >= n:
        return None
    return np.tile(blocks[root], n)


def tol(dtype: str, kwargs: dict) -> float:
    return 1e-5 if dtype == "float32" and "wire_dtype" not in kwargs \
        else 5e-2


@pytest.mark.parametrize(
    "func,dtype", CASES, ids=[f"{f[0]}-{d}" for f, d in CASES])
def test_collective_equals_jax(world, func, dtype):
    n, results = world
    cid, fn, kwargs, bitwise = func
    seed = CASES.index((func, dtype))
    x = host(n, seed)
    got = results[cid, dtype]
    assert len(got) == n
    got = np.concatenate(got)
    want = jax_shard_run(
        lambda b, axis: getattr(jcoll, fn)(b, axis, **_jax_kwargs(kwargs)),
        x, n, dtype)
    assert got.shape == want.shape and got.dtype == np.float32
    t = tol(dtype, kwargs)
    if bitwise:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=t, rtol=t)
    ref = oracle(fn, kwargs, rounded(x, dtype), n)
    if ref is not None:
        np.testing.assert_allclose(got, ref, atol=t, rtol=t)


@pytest.mark.parametrize("world", [4, 3], indirect=True,
                         ids=lambda n: f"world{n}")
def test_ring_refuses_an_indivisible_leading_axis_as_jax_does(world):
    n, results = world
    got = results["indivisible"]
    with pytest.raises(ValueError) as jax_err:
        jax_shard_run(jcoll.ring_reduce_scatter, host(n, 99, per=n + 2), n,
                      "float32")
    assert all(type(e) is ValueError for e in got)
    assert {str(e) for e in got} == {str(jax_err.value)}


@pytest.mark.parametrize("world", [4], indirect=True,
                         ids=lambda n: f"world{n}")
@pytest.mark.parametrize("fn,kwargs", SUBGROUP, ids=[f for f, _ in SUBGROUP])
def test_an_explicit_group_equals_jax_on_its_ranks(world, fn, kwargs):
    """Ranks 1-3 of 4 as the group: equal to JAX's on 3 devices, and the
    rank outside the group takes no part."""
    _, results = world
    got = results["subgroup", fn]
    assert got[0] is None
    want = jax_shard_run(
        lambda b, axis: getattr(jcoll, fn)(b, axis, **kwargs),
        host(3, 50), 3, "float32")
    np.testing.assert_array_equal(np.concatenate(got[1:]), want)


@pytest.mark.parametrize("step", [1, -1, 2])
@pytest.mark.parametrize("n", range(1, 9))
def test_ring_perm_equals_jax(n, step):
    assert pcoll.ring_perm(n, step) == jcoll.ring_perm(n, step)


def test_ppermute_refuses_a_perm_that_sends_twice():
    with launch.process_group("gloo", timeout_s=60):
        with pytest.raises(ValueError, match="sends or receives twice"):
            pcoll.ppermute(torch.zeros(4), [(0, 0), (0, 0)])
