"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip where no CUDA device is present. This file
imports no JAX (the card's machine has none); run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX).
"""

import pytest
import torch

from tpu_comm_torch.kernels import (
    jacobi1d,
    jacobi2d,
    jacobi3d,
    membw,
    run_steps,
)

MODS = {1: jacobi1d, 2: jacobi2d, 3: jacobi3d}
SHAPES = {
    1: [(3,), (4097,), (1 << 20,)],
    2: [(3, 3), (37, 301), (1024, 1024)],
    3: [(3, 3, 3), (19, 23, 45), (64, 64, 64)],
}
CHUNK_KEY = {1: "rows_per_chunk", 2: "rows_per_chunk", 3: "planes_per_chunk"}

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _field(shape, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(shape, generator=g, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_kernel_bitwise_equals_plain_version(card, dim, bc, dtype):
    mod = MODS[dim]
    for shape in SHAPES[dim]:
        u = _field(shape, dtype, seed=len(shape))
        got = mod.run(u, 5, bc=bc)
        want = run_steps(mod.step_plain, u, 5, bc)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want), shape


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_chunk_sets_the_grid_not_the_result(card, dim):
    mod = MODS[dim]
    u = _field(SHAPES[dim][1], torch.float32)
    ref = mod.step_stream(u, bc="periodic")
    for chunk in (1, 2, 3, 7, 1000):
        got = mod.step_stream(u, bc="periodic", **{CHUNK_KEY[dim]: chunk})
        assert torch.equal(got, ref), chunk


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_wrapper_counts_launches_and_checks_its_arguments(card, dim):
    mod = MODS[dim]
    u = _field(SHAPES[dim][1], torch.float32)
    before = mod.step_stream.launches
    out = torch.empty_like(u)
    assert mod.step_stream(u, out=out) is out
    assert mod.step_stream.launches == before + 1
    with pytest.raises(ValueError, match="alias"):
        mod.step_stream(u, out=u)
    with pytest.raises(ValueError, match="takes"):
        mod.step_stream(u.double())
    with pytest.raises(ValueError, match="-D field"):
        mod.step_stream(u.reshape(-1, 1) if dim == 1 else u.reshape(-1))
    if dim > 1:
        with pytest.raises(ValueError, match="contiguous"):
            mod.step_stream(u.transpose(0, 1))
    assert mod.step_stream.launches == before + 1


MEMBW_N = (128 * 8 * 3 + 128, 1 << 20)
MEMBW_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _membw_operands(n, dtype):
    return _field((n,), dtype, seed=1), _field((n,), dtype, seed=2)


@pytest.mark.parametrize("dtype", MEMBW_DTYPES)
@pytest.mark.parametrize("op", ["copy", "scale", "add", "triad"])
def test_membw_chunked_bitwise_equals_plain_version(card, op, dtype):
    for n in MEMBW_N:
        x, b = _membw_operands(n, dtype)
        want = membw.step_plain(x, b, 0.7, op)
        for aliased in (False, True):
            src = x.clone()
            got = membw.step_chunked(src, b, 0.7, op, aliased=aliased)
            torch.cuda.synchronize()
            assert (got.data_ptr() == src.data_ptr()) == aliased
            assert torch.equal(got, want), (n, aliased)
        # a view off the 16-byte grid takes the element-wise path
        xo, bo = x[1:1 + 1024], b[1:1 + 1024]
        assert torch.equal(membw.step_chunked(xo, bo, 0.7, op),
                           membw.step_plain(xo, bo, 0.7, op))


@pytest.mark.parametrize("dtype", MEMBW_DTYPES)
def test_membw_copies_are_bitwise(card, dtype):
    for n in MEMBW_N:
        x, _ = _membw_operands(n, dtype)
        assert torch.equal(membw.step_stream(x), x)
        src = x.clone()
        assert torch.equal(membw.step_stream(src, aliased=True), x)
        for depth in (2, 3, 4):
            for rows in (1, 3, 8, 64):
                got = membw.step_dma(x, rows_per_chunk=rows, depth=depth)
                torch.cuda.synchronize()
                assert torch.equal(got, x), (n, depth, rows)
    # fewer chunks than ring slots
    x = _field((128 * 3,), dtype)
    assert torch.equal(membw.step_dma(x, rows_per_chunk=1, depth=4), x)


def test_membw_chunk_sets_the_grid_not_the_result(card):
    x, b = _membw_operands(MEMBW_N[0], torch.float32)
    ref = membw.step_chunked(x, b, 0.7, "triad")
    for rows in (1, 2, 3, 7, 1000):
        assert torch.equal(membw.step_chunked(x, b, 0.7, "triad",
                                              rows_per_chunk=rows), ref)
        assert torch.equal(membw.step_stream(x, rows_per_chunk=rows), x)


def test_membw_wrappers_count_launches_and_check_arguments(card):
    x, b = _membw_operands(MEMBW_N[0], torch.float32)
    before = [w.launches for w in membw.WRAPPERS]
    out = torch.empty_like(x)
    assert membw.step_chunked(x, b, 1.0, "add", out=out) is out
    assert membw.step_stream(x, out=out) is out
    assert membw.step_dma(x, out=out) is out
    assert [w.launches for w in membw.WRAPPERS] == [c + 1 for c in before]
    with pytest.raises(ValueError, match="unless aliased"):
        membw.step_chunked(x, b, 1.0, "scale", out=x)
    with pytest.raises(ValueError, match="must not alias the input"):
        membw.step_dma(x, out=x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        membw.step_dma(x[1:1 + 1024])
    with pytest.raises(ValueError, match="shared memory"):
        membw.step_dma(x, rows_per_chunk=1024, depth=2)
    with pytest.raises(ValueError, match="multiple of 128"):
        membw.step_stream(x[:1000])
    with pytest.raises(ValueError, match="take"):
        membw.step_chunked(x.double(), b.double(), 1.0, "copy")
    assert [w.launches for w in membw.WRAPPERS] == [c + 1 for c in before]


BLOCK_SHAPES = {
    1: SHAPES[1] + [(5,)],
    2: SHAPES[2] + [(64, 256), (1001, 36)],
    3: SHAPES[3] + [(2, 3, 3), (130, 9, 33), (4, 8, 128)],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_block_kernel_bitwise_equals_plain_version(card, dim, bc, dtype):
    mod = MODS[dim]
    for shape in BLOCK_SHAPES[dim]:
        u = _field(shape, dtype, seed=len(shape))
        got = mod.run(u, 5, bc=bc, impl="block")
        want = run_steps(mod.step_plain, u, 5, bc)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want), shape
        if min(shape) >= 3:  # the stream arm takes no plane pair
            assert torch.equal(got, mod.run(u, 5, bc=bc)), shape


@pytest.mark.parametrize("dim", [1, 2])
def test_block_kernel_takes_views_off_the_16_byte_grid(card, dim):
    """An offset view takes the one-element-per-thread path."""
    base = _field((1 << 16) + 8, torch.float32)
    u = base[1:1 + 60000] if dim == 1 else base[3:3 + 200 * 300].view(200, 300)
    for bc in ("dirichlet", "periodic"):
        assert torch.equal(MODS[dim].step_block(u, bc),
                           MODS[dim].step_plain(u, bc))


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_block_wrapper_counts_launches_and_checks_its_arguments(card, dim):
    mod = MODS[dim]
    u = _field(SHAPES[dim][1], torch.float32)
    before = mod.step_block.launches
    out = torch.empty_like(u)
    assert mod.step_block(u, out=out) is out
    assert mod.step_block.launches == before + 1
    with pytest.raises(ValueError, match="alias"):
        mod.step_block(u, out=u)
    with pytest.raises(ValueError, match="takes"):
        mod.step_block(u.double())
    with pytest.raises(ValueError, match="extents must be >="):
        mod.step_block(u[(slice(0, 1),) * dim].contiguous())
    assert mod.step_block.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_pack_kernel_bitwise_equals_plain_version(card, dtype):
    from tpu_comm_torch.kernels import pack

    for shape in [(1, 1, 1), (3, 5, 7), (19, 23, 45), (130, 9, 33),
                  (64, 64, 64), (4, 8, 128)]:
        u = _field(shape, dtype, seed=3)
        before = pack.pack_faces.launches
        got = pack.pack_faces(u)
        torch.cuda.synchronize()
        assert pack.pack_faces.launches == before + 1
        for g, w in zip(got, pack.pack_faces_plain(u)):
            assert g.is_contiguous() and torch.equal(g, w), shape
    with pytest.raises(ValueError, match="contiguous"):
        pack.pack_faces(u.transpose(0, 1))
    with pytest.raises(ValueError, match="takes"):
        pack.pack_faces(u.double())


@pytest.mark.parametrize("impl,pack", [("torch", "fused"),
                                       ("overlap", "kernel"),
                                       ("block", "kernel"),
                                       ("stream", "fused")])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_mesh_of_one_on_the_card_through_nccl(card, bc, impl, pack):
    """``run_distributed_bench`` at world size 1: the NCCL group is created, a periodic
    axis exchanges with its own rank through NCCL's P2P calls, and the
    gathered field passes the golden."""
    from tpu_comm_torch.bench import stencil
    from tpu_comm_torch.kernels import pack as packmod

    counters = [MODS[3].step_block, MODS[3].step_stream, packmod.pack_faces]
    before = [w.launches for w in counters]
    rec = stencil.run_distributed_bench(stencil.StencilConfig(
        dim=3, size=48, iters=4, bc=bc, impl=impl, pack=pack, mesh=(1, 1, 1),
        verify=True, verify_iters=6, warmup=1, reps=2,
    ))
    assert rec["platform"] == "cuda" and rec["verified"] is True
    assert rec["workload"] == "stencil3d-dist" and rec["mesh"] == [1, 1, 1]
    launched = [w.launches > b for w, b in zip(counters, before)]
    assert launched == [impl == "block", impl == "stream", pack == "kernel"]
    tol = stencil.run_distributed_bench(stencil.StencilConfig(
        dim=3, size=48, iters=40, tol=1e-3, check_every=5, bc=bc, impl=impl,
        pack=pack, mesh=(1, 1, 1), verify=True, warmup=1, reps=1,
    ))
    assert tol["workload"] == "stencil3d-dist-conv" and tol["verified"]
