"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip where no CUDA device is present. This file
imports no JAX (the card's machine has none); run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX).
"""

import json

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


@pytest.mark.parametrize("dtype", MEMBW_DTYPES)
@pytest.mark.parametrize("aliased", [False, True])
@pytest.mark.parametrize("n", [128, 256, 384, 128 * 8 * 3 + 128, 1 << 20])
def test_membw_stream_forms_are_bitwise(card, n, aliased, dtype):
    """Out of place and in place, vector form (the tensor and a view one
    vector in) and scalar form (a view off the 16-byte grid), at ragged
    sizes and chunks."""
    x, _ = _membw_operands(n + 128, dtype)
    for off in (0, 1, 16 // x.element_size()):
        for rows in (None, 1, 3, 64):
            src = x.clone()
            view = src[off:off + n]
            got = membw.step_stream(view, rows, aliased=aliased)
            torch.cuda.synchronize()
            assert (got.data_ptr() == view.data_ptr()) == aliased
            assert torch.equal(got, x[off:off + n]), (off, rows)
            # nothing outside the view was written
            assert torch.equal(src[:off], x[:off])
            assert torch.equal(src[off + n:], x[off + n:])


@pytest.mark.parametrize("dtype", MEMBW_DTYPES)
@pytest.mark.parametrize("depth", range(2, membw.DMA_MAX_DEPTH + 1))
def test_membw_dma_is_bitwise_at_every_depth(card, depth, dtype):
    props = torch.cuda.get_device_properties(0)
    for n in MEMBW_N:
        x, _ = _membw_operands(n, dtype)
        for rows in (None, 1, 3, 8, 64):
            try:
                membw.dma_plan(
                    n, x.element_size(),
                    rows or membw.default_chunk("dma", dtype), depth,
                    props.multi_processor_count,
                    props.shared_memory_per_multiprocessor,
                    props.shared_memory_per_block_optin)
            except ValueError:
                with pytest.raises(ValueError, match="shared memory"):
                    membw.step_dma(x, rows_per_chunk=rows, depth=depth)
                continue
            got = membw.step_dma(x, rows_per_chunk=rows, depth=depth)
            torch.cuda.synchronize()
            assert torch.equal(got, x), (n, rows)
    # fewer chunks than slots on the card, and per CTA (depth - 1 chunks
    # a CTA, the last one ragged)
    x = _field((128 * (depth - 1),), dtype)
    assert torch.equal(membw.step_dma(x, rows_per_chunk=1, depth=depth), x)
    plan = membw.dma_plan(1, 4, 16, depth, props.multi_processor_count,
                          props.shared_memory_per_multiprocessor,
                          props.shared_memory_per_block_optin)
    n = plan.per_sm * props.multi_processor_count * (depth - 1) * 16 * 128
    x = _field((n - 128 * 8,), torch.float32)
    assert torch.equal(membw.step_dma(x, rows_per_chunk=16, depth=depth), x)


@pytest.mark.parametrize("depth", [2, membw.DMA_MAX_DEPTH])
def test_membw_dma_verify_wraps_every_ring(card, depth, monkeypatch,
                                           tmp_path):
    """``membw --op copy --impl dma --verify`` copies, byte for byte, a
    buffer in which every CTA of ``dma_plan`` takes ``depth + 1`` chunks,
    so every slot of every ring is refilled."""
    from tpu_comm_torch import cli

    verified = []
    chained = membw.chained

    def spy(x, *args, **kwargs):
        verified.append(x.numel())
        return chained(x, *args, **kwargs)

    # a membw run's first pass is its verification
    monkeypatch.setattr(membw, "chained", spy)
    size = 1 << 24
    path = tmp_path / "rows.jsonl"
    assert cli.main(["membw", "--op", "copy", "--impl", "dma", "--depth",
                     str(depth), "--size", str(size), "--iters", "2",
                     "--warmup", "1", "--reps", "1", "--jsonl",
                     str(path)]) == 0
    row = json.loads(path.read_text())
    assert row["verified"] is True and row["platform"] == "cuda"
    props = torch.cuda.get_device_properties(0)
    limits = (props.multi_processor_count,
              props.shared_memory_per_multiprocessor,
              props.shared_memory_per_block_optin)
    rows = membw.default_chunk("dma", torch.float32)
    assert verified[0] == membw.dma_verify_size(size, 4, rows, depth,
                                                *limits) < size
    plan = membw.dma_plan(verified[0], 4, rows, depth, *limits)
    assert min(len(plan.chunks_of(b)) for b in range(plan.ctas)) >= depth + 1


def test_membw_chunk_sets_the_grid_not_the_result(card):
    x, b = _membw_operands(MEMBW_N[0], torch.float32)
    ref = membw.step_chunked(x, b, 0.7, "triad")
    for rows in (1, 2, 3, 7, 1000):
        assert torch.equal(membw.step_chunked(x, b, 0.7, "triad",
                                              rows_per_chunk=rows), ref)
        assert torch.equal(membw.step_stream(x, rows_per_chunk=rows), x)
    for rows in (1, 2, 3, 7, 100):
        assert torch.equal(membw.step_dma(x, rows_per_chunk=rows), x)


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
    """Every path of the kernel: y rows as 16-byte vectors and cell by
    cell, a base off the 16-byte grid, nx = 1, ny = 1, nz above 65535,
    and 512^3, where the warps stride over the items."""
    from tpu_comm_torch.kernels import pack

    def held(u):
        before = pack.pack_faces.launches
        got = pack.pack_faces(u)
        torch.cuda.synchronize()
        assert pack.pack_faces.launches == before + 1
        for g, w in zip(got, pack.pack_faces_plain(u)):
            assert g.is_contiguous() and torch.equal(g, w), u.shape

    for shape in [(1, 1, 1), (3, 5, 7), (19, 23, 45), (130, 9, 33),
                  (64, 64, 64), (4, 8, 128), (5, 7, 64), (3, 4, 8),
                  (4, 6, 34), (7, 300, 1), (9, 1, 300), (70000, 3, 5),
                  (66000, 2, 8), (512, 512, 512)]:
        held(_field(shape, dtype, seed=3))
    flat = _field((64 * 64 * 64 + 1,), dtype, seed=5)
    u = flat[1:].view(64, 64, 64)
    assert u.data_ptr() % 16 != 0
    held(u)
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


BOX_SHAPES = {
    9: [(3, 3), (37, 301), (1001, 37), (64, 256)],
    27: [(3, 3, 3), (19, 23, 45), (130, 9, 33), (4, 8, 128)],
}
BOX_CHUNK_KEY = {9: "rows_per_chunk", 27: "planes_per_chunk"}


def _box(points):
    from tpu_comm_torch.kernels import stencil9, stencil27

    return {9: stencil9, 27: stencil27}[points]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("points", [9, 27])
def test_box_kernels_bitwise_equal_plain_version(card, points, bc, dtype):
    mod = _box(points)
    shapes = BOX_SHAPES[points] + ([(2, 3, 3)] if points == 27 else [])
    for shape in shapes:
        u = _field(shape, dtype, seed=len(shape))
        want = run_steps(mod.step_plain, u, 5, bc)
        for impl in ("stream", "block"):
            got = mod.run(u, 5, bc=bc, impl=impl)
            torch.cuda.synchronize()
            assert got.dtype == dtype and torch.equal(got, want), (shape,
                                                                   impl)


@pytest.mark.parametrize("points", [9, 27])
def test_box_stream_chunk_sets_the_grid_not_the_result(card, points):
    mod = _box(points)
    u = _field(BOX_SHAPES[points][1], torch.float32)
    ref = mod.step_stream(u, bc="periodic")
    for chunk in (1, 2, 3, 7, 1000):
        got = mod.step_stream(u, bc="periodic",
                              **{BOX_CHUNK_KEY[points]: chunk})
        assert torch.equal(got, ref), chunk


@pytest.mark.parametrize("arm", ["step_stream", "step_block"])
@pytest.mark.parametrize("points", [9, 27])
def test_box_wrappers_count_launches_and_refuse_aliasing(card, points, arm):
    wrapper = getattr(_box(points), arm)
    u = _field(BOX_SHAPES[points][1], torch.float32)
    before = wrapper.launches
    out = torch.empty_like(u)
    assert wrapper(u, out=out) is out
    assert wrapper.launches == before + 1
    with pytest.raises(ValueError, match="alias"):
        wrapper(u, out=u)
    with pytest.raises(ValueError, match="takes"):
        wrapper(u.double())
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(u.transpose(0, 1))
    assert wrapper.launches == before + 1


@pytest.mark.parametrize("impl", ["torch", "overlap", "block", "stream"])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("points", [9, 27])
def test_box_mesh_of_one_on_the_card_through_nccl(card, points, bc, impl):
    """The box stencils at world size 1: each axis of the chained exchange
    is its own NCCL batch to the own rank, and the gathered field passes
    the golden."""
    from tpu_comm_torch.bench import stencil

    mod = _box(points)
    dim = 2 if points == 9 else 3
    counters = [mod.step_block, mod.step_stream]
    before = [w.launches for w in counters]
    rec = stencil.run_distributed_bench(stencil.StencilConfig(
        dim=dim, points=points, size=48, iters=4, bc=bc, impl=impl,
        mesh=(1,) * dim, verify=True, verify_iters=6, warmup=1, reps=2,
    ))
    assert rec["platform"] == "cuda" and rec["verified"] is True
    assert rec["workload"] == f"stencil{dim}d-{points}pt-dist"
    launched = [w.launches > b for w, b in zip(counters, before)]
    assert launched == [impl == "block", impl == "stream"]


#: temporal blocking: the families with a multi kernel (the star's dim or
#: the 9-point box) and the shapes their kernels are held at
MULTI_SHAPES = {
    1: [(3,), (4097,), (1 << 20,)],
    2: [(3, 3), (37, 301), (1001, 37), (512, 512)],
    9: [(3, 3), (37, 301), (1001, 37), (512, 512)],
}


def _multi(key):
    from tpu_comm_torch.kernels import stencil9

    return {1: jacobi1d, 2: jacobi2d, 9: stencil9}[key]


def _t_max(key):
    from tpu_comm_torch.kernels.tiling import MULTI_T_MAX

    return MULTI_T_MAX[1 if key == 1 else 2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("key", [1, 2, 9])
def test_multi_kernel_bitwise_equals_plain_version(card, key, bc, dtype):
    """t = 1, 2, 8 and one more than a launch takes (two chained launches
    through the f32 scratch field): one narrowing in every case."""
    mod = _multi(key)
    for shape in MULTI_SHAPES[key]:
        u = _field(shape, dtype, seed=len(shape))
        for t in (1, 2, 8, _t_max(key) + 1):
            got = mod.step_multi(u, bc, t)
            want = mod.step_multi_plain(u, bc, t)
            torch.cuda.synchronize()
            assert got.dtype == dtype and torch.equal(got, want), (shape, t)
        if dtype == torch.float32:
            assert torch.equal(mod.step_multi(u, bc, 1),
                               mod.step_block(u, bc)), shape


@pytest.mark.parametrize("key", [1, 2, 9])
def test_multi_tile_sets_the_grid_not_the_result(card, key):
    mod = _multi(key)
    u = _field(MULTI_SHAPES[key][1], torch.float32)
    ref = mod.step_multi(u, "periodic", 8)
    tiles = ([{"rows_per_chunk": r} for r in (1, 2, 3, 7, 100)]
             if key == 1 else
             [{"rows_per_chunk": r, "cols_per_chunk": c}
              for r, c in ((1, 1), (3, 5), (40, 72), (7, 300), (128, 32))])
    for tile in tiles:
        got = mod.step_multi(u, "periodic", 8, **tile)
        assert torch.equal(got, ref), tile


#: 2D fields whose strips mix lanes that load and store 16-byte vectors
#: (inside the field, on the 16-byte grid) with lanes that wrap the edges
#: or load scalars: rows a multiple of 4 wide and not, several strips and
#: tiles a row, several tile rows
MULTI2D_STRIP_SHAPES = [(300, 1024), (300, 1021), (61, 517), (130, 250)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("key", [2, 9])
def test_multi2d_interior_strips_beside_wrapping_edges(card, key, bc, dtype):
    """Interior strips (vector loads, no ring test) beside the edge
    strips that wrap or hold the dirichlet ring, at t = 1..8 in one
    launch and beyond (chained) and at tiles that cut a row into several
    strips and several tiles, bitwise."""
    mod = _multi(key)
    for shape in MULTI2D_STRIP_SHAPES:
        u = _field(shape, dtype, seed=shape[1])
        for t in (1, 3, 7, 8, 9, 16):
            want = mod.step_multi_plain(u, bc, t)
            for tile in ({}, {"rows_per_chunk": 37, "cols_per_chunk": 300},
                         {"rows_per_chunk": 128, "cols_per_chunk": 53}):
                got = mod.step_multi(u, bc, t, **tile)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (shape, t, tile)


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("key", [2, 9])
def test_multi2d_takes_views_off_the_16_byte_grid(card, key, bc):
    mod = _multi(key)
    for dtype in (torch.float32, torch.bfloat16):
        base = _field(300 * 1024 + 8, dtype)
        for off, shape in ((1, (300, 1024)), (3, (257, 1020)),
                           (4, (300, 1024))):
            u = base[off:off + shape[0] * shape[1]].view(shape)
            out = torch.empty(shape[0] * shape[1] + 1, dtype=dtype,
                              device="cuda")[1:].view(shape)
            for t in (2, 8, 16):
                got = mod.step_multi(u, bc, t, out=out)
                want = mod.step_multi_plain(u, bc, t)
                assert torch.equal(got, want), (off, shape, t)


@pytest.mark.parametrize("key", [1, 2, 9])
def test_multi_wrapper_counts_launches_and_checks_its_arguments(card, key):
    mod = _multi(key)
    u = _field(MULTI_SHAPES[key][1], torch.float32)
    before = mod.step_multi.launches
    out = torch.empty_like(u)
    assert mod.step_multi(u, t_steps=8, out=out) is out
    assert mod.step_multi.launches == before + 1
    mod.step_multi(u, t_steps=2 * _t_max(key) + 1)
    assert mod.step_multi.launches == before + 4  # three chained launches
    with pytest.raises(ValueError, match="alias"):
        mod.step_multi(u, out=u)
    with pytest.raises(ValueError, match="takes"):
        mod.step_multi(u.double())
    with pytest.raises(ValueError, match="t_steps must be >= 1"):
        mod.step_multi(u, t_steps=0)
    with pytest.raises(ValueError, match="tile must be >= 1"):
        mod.step_multi(u, rows_per_chunk=0)
    if key == 1:
        with pytest.raises(ValueError, match="shared memory"):
            mod.step_multi(u, rows_per_chunk=1 << 12)
        assert mod.step_multi.launches == before + 4
    else:
        # a 2D block is one warp walking its tile: any tile fits
        assert torch.equal(mod.step_multi(u, rows_per_chunk=1 << 12),
                           mod.step_multi(u))
        assert mod.step_multi.launches == before + 6


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("dim,points", [(1, 0), (2, 0), (3, 0), (2, 9),
                                        (3, 27)])
def test_multi_mesh_of_one_on_the_card_through_nccl(card, dim, points, bc):
    """The mesh ``multi`` arm at world size 1: one width-3 chained
    exchange through NCCL to the own rank, three steps of the padded
    block; the gathered field passes the golden and no kernel runs."""
    from tpu_comm_torch.bench import stencil

    mod = _multi(points or dim) if (points or dim) in (1, 2, 9) else None
    before = None if mod is None else mod.step_multi.launches
    rec = stencil.run_distributed_bench(stencil.StencilConfig(
        dim=dim, points=points, size=24, iters=6, t_steps=3, bc=bc,
        impl="multi", mesh=(1,) * dim, verify=True, verify_iters=4,
        warmup=1, reps=2,
    ))
    assert rec["platform"] == "cuda" and rec["verified"] is True
    assert (rec["impl"], rec["t_steps"]) == ("multi", 3)
    if mod is not None:
        assert mod.step_multi.launches == before


#: the single-device arms of slice 6: arm -> the dims it runs and its bcs
STAGED_ARMS = {
    "grid": ((1, 2), ("dirichlet", "periodic")),
    "wave": ((1, 2), ("dirichlet",)),
    "stream2": ((1,), ("dirichlet", "periodic")),
}
STAGED_CASES = [(arm, dim, bc) for arm, (dims, bcs) in STAGED_ARMS.items()
                for dim in dims for bc in bcs]
#: shapes past a chunk's seams and ragged at the field's end
STAGED_SHAPES = {
    1: [(3,), (1001,), (1000001,), (1 << 20,)],
    2: [(3, 3), (37, 301), (1001, 37), (300, 1030), (1024, 1024)],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("arm,dim,bc", STAGED_CASES)
def test_staged_kernels_bitwise_equal_plain_version(card, arm, dim, bc,
                                                    dtype):
    mod = MODS[dim]
    for shape in STAGED_SHAPES[dim]:
        u = _field(shape, dtype, seed=len(shape))
        got = mod.run(u, 5, bc=bc, impl=arm)
        want = run_steps(mod.step_plain, u, 5, bc)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want), shape


@pytest.mark.parametrize("arm,dim,bc", STAGED_CASES)
def test_staged_chunk_sets_the_grid_not_the_result(card, arm, dim, bc):
    mod = MODS[dim]
    u = _field(STAGED_SHAPES[dim][-2], torch.float32)
    step = mod.STEPS[arm]
    ref = step(u, bc)
    for chunk in (1, 2, 3, 7, 24):
        assert torch.equal(step(u, bc, rows_per_chunk=chunk), ref), chunk


@pytest.mark.parametrize("arm,dim,bc", STAGED_CASES)
def test_staged_kernels_take_views_off_the_16_byte_grid(card, arm, dim, bc):
    """The field's unaligned ends go by plain loads, the rest by bulk
    copies."""
    base = _field((1 << 16) + 8, torch.float32)
    u = base[1:1 + 60000] if dim == 1 else base[3:3 + 200 * 300].view(200, 300)
    step = MODS[dim].STEPS[arm]
    assert torch.equal(step(u, bc), MODS[dim].step_plain(u, bc))


@pytest.mark.parametrize("arm,dim", [(a, d) for a, (dims, _) in
                                     STAGED_ARMS.items() for d in dims])
def test_staged_wrappers_count_launches_and_check_arguments(card, arm, dim):
    mod = MODS[dim]
    step = mod.STEPS[arm]
    u = _field(STAGED_SHAPES[dim][1], torch.float32)
    before = step.launches
    out = torch.empty_like(u)
    assert step(u, out=out) is out
    assert step.launches == before + 1
    with pytest.raises(ValueError, match="alias"):
        step(u, out=u)
    with pytest.raises(ValueError, match="takes"):
        step(u.double())
    if arm == "wave":
        with pytest.raises(ValueError, match="bc='dirichlet' only"):
            step(u, "periodic")
    if arm != "stream2":
        with pytest.raises(ValueError, match="shared memory"):
            step(u, rows_per_chunk=1 << 12)
    assert step.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("dim,points", [(1, 0), (2, 0), (3, 0), (2, 9),
                                        (3, 27)])
def test_torch_arm_on_the_card_launches_no_kernel(card, dim, points, bc,
                                                  dtype):
    """The single-device torch arm runs plain PyTorch in the field's
    dtype on the card: the same values as on the CPU, no kernel of the
    port."""
    from tpu_comm_torch.kernels import kernels_for

    mod = kernels_for(dim, points)
    shape = {1: (1001,), 2: (37, 301), 3: (19, 23, 45)}[dim]
    u = _field(shape, dtype)
    counts = [w.launches for w in (mod.step_stream, mod.step_block)]
    got = mod.run(u, 3, bc=bc, impl="torch")
    want = mod.run(u.cpu(), 3, bc=bc, impl="torch")
    assert torch.equal(got.cpu(), want)
    assert [w.launches for w in (mod.step_stream, mod.step_block)] == counts


#: the Trap-1 family of slice 7: the two box waves and the 3D wavefront
BOX_WAVE_SHAPES = {
    9: [(3, 3), (37, 301), (1001, 37), (300, 1030), (1024, 1024)],
    27: [(3, 3, 3), (2, 5, 7), (19, 23, 45), (130, 9, 33), (64, 64, 64)],
}
MULTI3D_SHAPES = [(3, 3, 3), (2, 5, 7), (19, 23, 45), (130, 9, 33),
                  (64, 64, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("points", [9, 27])
def test_box_wave_kernels_bitwise_equal_plain_version(card, points, dtype):
    mod = _box(points)
    for shape in BOX_WAVE_SHAPES[points]:
        u = _field(shape, dtype, seed=len(shape))
        got = mod.run(u, 5, bc="dirichlet", impl="wave")
        want = run_steps(mod.step_plain, u, 5, "dirichlet")
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want), shape


@pytest.mark.parametrize("points", [9, 27])
def test_box_wave_chunk_sets_the_grid_not_the_result(card, points):
    mod = _box(points)
    u = _field(BOX_WAVE_SHAPES[points][-2], torch.float32)
    ref = mod.step_wave(u)
    for chunk in (1, 2, 3, 7, 9, 16):
        assert torch.equal(mod.step_wave(u, rows_per_chunk=chunk), ref), chunk


@pytest.mark.parametrize("points", [9, 27])
def test_box_wave_takes_views_off_the_16_byte_grid(card, points):
    base = _field((1 << 16) + 8, torch.float32)
    shape = (200, 300) if points == 9 else (6, 40, 250)
    n = 1
    for s in shape:
        n *= s
    u = base[3:3 + n].view(shape)
    mod = _box(points)
    assert torch.equal(mod.step_wave(u), mod.step_plain(u))


@pytest.mark.parametrize("points", [9, 27])
def test_box_wave_wrappers_count_launches_and_check_arguments(card, points):
    mod = _box(points)
    u = _field(BOX_WAVE_SHAPES[points][2], torch.float32)
    before = mod.step_wave.launches
    out = torch.empty_like(u)
    assert mod.step_wave(u, out=out) is out
    assert mod.step_wave.launches == before + 1
    with pytest.raises(ValueError, match="alias"):
        mod.step_wave(u, out=u)
    with pytest.raises(ValueError, match="takes"):
        mod.step_wave(u.double())
    with pytest.raises(ValueError, match="bc='dirichlet' only"):
        mod.step_wave(u, "periodic")
    with pytest.raises(ValueError, match="shared memory"):
        mod.step_wave(u, rows_per_chunk=1 << 12)
    if points == 27:
        with pytest.raises(ValueError, match="at most 16 rows"):
            mod.step_wave(u, rows_per_chunk=17)
    assert mod.step_wave.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_multi3d_kernel_bitwise_equals_plain_version(card, dtype):
    """t = 1, 2, the most a launch takes, and one more than twice that
    (three chained launches through the f32 scratch field): one narrowing
    in every case."""
    from tpu_comm_torch.kernels.tiling import MULTI_T_MAX

    t_max = MULTI_T_MAX[3]
    for shape in MULTI3D_SHAPES:
        u = _field(shape, dtype, seed=len(shape) + shape[0])
        for t in (1, 2, t_max, 2 * t_max + 1):
            got = jacobi3d.step_multi(u, "dirichlet", t)
            want = jacobi3d.step_multi_plain(u, "dirichlet", t)
            torch.cuda.synchronize()
            assert got.dtype == dtype and torch.equal(got, want), (shape, t)
        if dtype == torch.float32:
            assert torch.equal(jacobi3d.step_multi(u, "dirichlet", 1),
                               jacobi3d.step_block(u, "dirichlet")), shape


def test_multi3d_tile_sets_the_grid_not_the_result(card):
    u = _field(MULTI3D_SHAPES[2], torch.float32)
    ref = jacobi3d.step_multi(u, "dirichlet", 4)
    for rows, cols in ((1, 1), (3, 5), (8, 24), (24, 8), (5, 19)):
        got = jacobi3d.step_multi(u, "dirichlet", 4, rows_per_chunk=rows,
                                  cols_per_chunk=cols)
        assert torch.equal(got, ref), (rows, cols)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi3d_interior_blocks_beside_edge_blocks(card, dtype):
    """Blocks whose window holds no shell cell (no ring or field tests)
    beside edge blocks, at t = 1..4 and at tiles that leave interior
    blocks, z ranges of several planes, bitwise."""
    for shape in ((40, 150, 150), (9, 100, 203)):
        u = _field(shape, dtype, seed=shape[2])
        for t in (1, 2, 3, 4):
            want = jacobi3d.step_multi_plain(u, "dirichlet", t)
            for rows, cols in ((24, 56), (16, 24), (8, 24), (20, 40)):
                got = jacobi3d.step_multi(u, "dirichlet", t,
                                          rows_per_chunk=rows,
                                          cols_per_chunk=cols)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (shape, t, rows, cols)


def test_multi3d_mesh_wave_arm_of_one(card):
    """The mesh ``wave`` arm in 3D at world size 1: each step launches the
    wavefront at t = 1 on the rank's block (through NCCL to itself), and
    the gathered field passes the golden."""
    from tpu_comm_torch.bench import stencil

    before = jacobi3d.step_multi.launches
    rec = stencil.run_distributed_bench(stencil.StencilConfig(
        dim=3, size=40, iters=4, bc="dirichlet", impl="wave",
        mesh=(1, 1, 1), verify=True, verify_iters=4, warmup=1, reps=2,
    ))
    assert rec["platform"] == "cuda" and rec["verified"] is True
    assert jacobi3d.step_multi.launches > before


def test_multi3d_takes_views_off_the_16_byte_grid(card):
    base = _field((1 << 16) + 8, torch.float32)
    u = base[3:3 + 6 * 40 * 250].view(6, 40, 250)
    assert torch.equal(jacobi3d.step_multi(u, "dirichlet", 3),
                       jacobi3d.step_multi_plain(u, "dirichlet", 3))


def test_multi3d_wrapper_counts_launches_and_checks_its_arguments(card):
    from tpu_comm_torch.kernels.tiling import MULTI_T_MAX

    u = _field(MULTI3D_SHAPES[2], torch.float32)
    before = jacobi3d.step_multi.launches
    out = torch.empty_like(u)
    assert jacobi3d.step_multi(u, t_steps=4, out=out) is out
    assert jacobi3d.step_multi.launches == before + 1
    jacobi3d.step_multi(u, t_steps=2 * MULTI_T_MAX[3] + 1)
    assert jacobi3d.step_multi.launches == before + 4  # three chained
    with pytest.raises(ValueError, match="alias"):
        jacobi3d.step_multi(u, out=u)
    with pytest.raises(ValueError, match="takes"):
        jacobi3d.step_multi(u.double())
    with pytest.raises(ValueError, match="bc='dirichlet' only"):
        jacobi3d.step_multi(u, "periodic")
    with pytest.raises(ValueError, match="t_steps must be >= 1"):
        jacobi3d.step_multi(u, t_steps=0)
    with pytest.raises(ValueError, match="tile must be >= 1"):
        jacobi3d.step_multi(u, rows_per_chunk=0)
    # a tile whose window needs more threads than a block has is cut to
    # one that fits (tiling.multi3d_block_tile): taken, same result
    assert torch.equal(jacobi3d.step_multi(u, rows_per_chunk=1000),
                       jacobi3d.step_multi(u))
    assert jacobi3d.step_multi.launches == before + 6


#: blocks of the ghost-fed wave kernels (the mesh wave arm's 1D and 2D
#: update): one cell, one row, one column, ragged, several strips
GHOST_SHAPES = {
    1: [(1,), (2,), (1001,), (1000001,), (1 << 20,)],
    2: [(1, 1), (1, 300), (300, 1), (37, 301), (1001, 37), (300, 1030)],
}


def _ghost_lines(shape, dtype, seed):
    if len(shape) == 1:
        shapes = [(1,), (1,)]
    else:
        shapes = [(1, shape[1]), (1, shape[1]), (shape[0], 1),
                  (shape[0], 1)]
    return [_field(s, dtype, seed + i) + 0.5 for i, s in enumerate(shapes)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dim", [1, 2])
def test_wave_ghost_kernels_bitwise_equal_plain_version(card, dim, dtype):
    """Five chained steps with fresh ghost lines each step."""
    mod = MODS[dim]
    for shape in GHOST_SHAPES[dim]:
        got = want = _field(shape, dtype, seed=len(shape))
        for step in range(5):
            g = [x.to(dtype) for x in _ghost_lines(shape, torch.float32,
                                                   10 * step)]
            got = mod.step_wave_ghost(got, *g)
            want = mod.step_wave_ghost_plain(want, *g)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want), shape


@pytest.mark.parametrize("dim", [1, 2])
def test_wave_ghost_chunk_sets_the_grid_not_the_result(card, dim):
    mod = MODS[dim]
    shape = GHOST_SHAPES[dim][-2]
    u = _field(shape, torch.float32)
    g = _ghost_lines(shape, torch.float32, 3)
    ref = mod.step_wave_ghost(u, *g)
    for chunk in (1, 2, 3, 7, 9, 16):
        got = mod.step_wave_ghost(u, *g, rows_per_chunk=chunk)
        assert torch.equal(got, ref), chunk


@pytest.mark.parametrize("dim", [1, 2])
def test_wave_ghost_takes_views_off_the_16_byte_grid(card, dim):
    """The block and its ghost lines at addresses off the 16-byte grid."""
    shape = (30001,) if dim == 1 else (200, 300)
    n = 1
    for s in shape:
        n *= s
    base = _field(n + 8, torch.float32)
    u = base[3:3 + n].view(shape)
    g = []
    for i, line in enumerate(_ghost_lines(shape, torch.float32, 5)):
        flat = _field(line.numel() + 4, torch.float32, seed=40 + i)
        g.append(flat[1:1 + line.numel()].view(line.shape))
    mod = MODS[dim]
    assert torch.equal(mod.step_wave_ghost(u, *g),
                       mod.step_wave_ghost_plain(u, *g))


@pytest.mark.parametrize("dim", [1, 2])
def test_wave_ghost_wrappers_count_launches_and_check_arguments(card, dim):
    mod = MODS[dim]
    shape = GHOST_SHAPES[dim][-2]
    u = _field(shape, torch.float32)
    g = _ghost_lines(shape, torch.float32, 7)
    before = mod.step_wave_ghost.launches
    out = torch.empty_like(u)
    assert mod.step_wave_ghost(u, *g, out=out) is out
    assert mod.step_wave_ghost.launches == before + 1
    with pytest.raises(ValueError, match="alias"):
        mod.step_wave_ghost(u, *g, out=u)
    with pytest.raises(ValueError, match="ghost"):
        mod.step_wave_ghost(u, g[0][..., :0], *g[1:])
    with pytest.raises(ValueError, match="dtype and device"):
        mod.step_wave_ghost(u, g[0].cpu(), *g[1:])
    with pytest.raises(ValueError, match="shared memory"):
        mod.step_wave_ghost(u, *g, rows_per_chunk=1 << 12)
    assert mod.step_wave_ghost.launches == before + 1


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("dim,points", [(1, 0), (2, 0), (3, 0), (2, 9),
                                        (3, 27)])
def test_wave_mesh_of_one_on_the_card_through_nccl(card, dim, points, bc):
    """The mesh ``wave`` arm at world size 1, ghosts through NCCL to the
    own rank: the gathered field passes the golden, one launch of the
    arm's kernel a step."""
    from tpu_comm_torch.bench import stencil
    from tpu_comm_torch.kernels import kernels_for

    family = kernels_for(dim, points)
    wrapper = (family.step_wave_ghost if dim < 3 and not points
               else family.step_multi if dim == 3 and not points
               else family.step_wave)
    before = wrapper.launches
    rec = stencil.run_distributed_bench(stencil.StencilConfig(
        dim=dim, points=points, size=40, iters=3, bc=bc, impl="wave",
        mesh=(1,) * dim, verify=True, verify_iters=4, warmup=1, reps=1,
    ))
    assert rec["platform"] == "cuda" and rec["verified"] is True
    assert rec["impl"] == "wave"
    # verify, then iters and 3 * iters a timed run
    assert wrapper.launches - before == 4 + 2 * 4 * 3


def _all_launches() -> int:
    """Launches of every kernel wrapper of the port so far."""
    from tpu_comm_torch.kernels import kernels_for, pack

    wrappers = {pack.pack_faces, *membw.WRAPPERS}
    for dim, points in [(1, 0), (2, 0), (3, 0), (2, 9), (3, 27)]:
        family = kernels_for(dim, points)
        wrappers.update(family.STEPS.values())
        for name in ("step_multi", "step_wave_ghost", "step_wave"):
            if hasattr(family, name):
                wrappers.add(getattr(family, name))
    return sum(getattr(w, "launches", 0) for w in wrappers)


#: the sweep's ops at world size 1: (op, wire dtype, accumulation dtype)
SWEEP_CARD_OPS = [(op, None, None) for op in (
    "allreduce", "allreduce-ring", "rs-ag", "ppermute", "bcast",
    "bcast-tree", "all-to-all")] + [("allreduce-ring", "bfloat16",
                                     "float32")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op,wire,acc", SWEEP_CARD_OPS)
def test_sweep_at_world_size_1_on_the_card(card, op, wire, acc, dtype):
    """The sweep through NCCL at world size 1: verified rows of every
    size, ``gbps_bus`` 0.0 (no link), and no kernel of the port."""
    from tpu_comm_torch.bench import SWEEP_OPS
    from tpu_comm_torch.bench.sweep import SweepConfig, run_sweep

    assert op in SWEEP_OPS
    before = _all_launches()
    cfg = SweepConfig(op=op, n_devices=1, dtype=dtype, wire_dtype=wire,
                      acc_dtype=acc, max_bytes=1 << 20, iters=5, warmup=1,
                      reps=2)
    rows = run_sweep(cfg)
    assert [r["size"] for r in rows] == cfg.sizes()
    for r in rows:
        assert (r["platform"], r["backend"], r["verified"], r["mesh"]) == (
            "cuda", "cuda", True, [1])
        assert r["gbps_bus"] == (None if r["below_timing_resolution"]
                                 else 0.0)
    assert _all_launches() == before


def test_sweep_refuses_more_ranks_than_cards(card, capsys):
    from tpu_comm_torch import cli

    n = torch.cuda.device_count() + 1
    assert cli.main(["sweep", "--n-devices", str(n), "--max-bytes",
                     "1024"]) == 2
    assert f"needs {n} CUDA devices" in capsys.readouterr().err


def test_profile_traces_the_kernels_and_nccl_on_the_card(card, tmp_path):
    """``stencil --profile`` of the 3D block step on a mesh of one,
    periodic (the self-exchange through NCCL): one trace, holding the
    block kernel and an NCCL kernel; the row as without the trace."""
    from tpu_comm_torch.bench import stencil
    from tpu_comm_torch.bench.trace import trace_ops

    common = dict(dim=3, size=64, iters=3, bc="periodic", impl="block",
                  pack="kernel", mesh=(1, 1, 1), verify=True,
                  verify_iters=2, warmup=1, reps=1)
    plain = stencil.run_distributed_bench(stencil.StencilConfig(**common))
    row = stencil.run_distributed_bench(stencil.StencilConfig(
        profile=str(tmp_path), **common))
    assert sorted(row) == sorted(plain) and row["verified"] is True
    assert [p.name for p in tmp_path.iterdir()] == ["rank0.json"]
    ops = trace_ops(tmp_path / "rank0.json")
    assert any("jacobi3d_block" in name for name in ops), sorted(ops)
    assert any("nccl" in name.lower() for name in ops), sorted(ops)


def _mesh_of_one(dim, bc, size, dtype=torch.float32, device="cuda"):
    """The decomposition of a mesh of one and a seeded block on
    ``device``."""
    from tpu_comm_torch.domain import Decomposition
    from tpu_comm_torch.kernels.reference import init_field
    from tpu_comm_torch.topo import make_cart_mesh

    dec = Decomposition(make_cart_mesh(dim, periodic=bc == "periodic"),
                        (size,) * dim)
    u0 = init_field((size,) * dim, kind="random", seed=dim)
    return dec, dec.scatter(u0, device, dtype)


def _chains(graphs: dict) -> list:
    """The graphs of a runners' cache (it also holds their buffers)."""
    from tpu_comm_torch.kernels.graphs import Graph

    return [g for g in graphs.values() if isinstance(g, Graph)]


@pytest.mark.parametrize("impl", ["block", "stream"])
@pytest.mark.parametrize("dim", [2, 3])
def test_graph_replayed_chain_equals_eager(card, dim, impl):
    """A chain of 20 steps captured in a CUDA graph (exchange through
    NCCL to the own rank included) and replayed, once (fuse 20) and four
    times (fuse 5), equals the eager run bitwise; the counters read the
    launches the card made, the same as the eager run's."""
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.kernels import distributed as pdist, launch_wrappers

    size = {2: 512, 3: 64}[dim]
    with launch.process_group("nccl"):
        dec, u = _mesh_of_one(dim, "periodic", size)
        keep = u.clone()
        wrappers = launch_wrappers()
        before = [w.launches for w in wrappers]
        want = pdist._run_distributed_eager(u, dec, 20, bc="periodic",
                                            impl=impl)
        eager = [w.launches - b for w, b in zip(wrappers, before)]
        for fuse in (20, 5):
            graphs = {}
            before = [w.launches for w in wrappers]
            got, n = pdist.run_distributed_fused(
                u, dec, 20, fuse, bc="periodic", impl=impl, graphs=graphs)
            torch.cuda.synchronize()
            (chain,) = _chains(graphs)
            assert n == 20 // fuse and chain.replays == n - 1
            assert [w.launches - b for w, b in zip(wrappers, before)] == eager
            assert sum(chain.captured.values()) == sum(eager) // n
            assert torch.equal(got, want) and torch.equal(u, keep)
            pdist.release_graphs(graphs)


@pytest.mark.parametrize("impl", ["torch", "overlap", "block"])
@pytest.mark.parametrize("dim", [2, 3])
def test_bf16_wire_at_world_size_1_equals_cpu(card, dim, impl):
    """A bfloat16 halo wire through NCCL at world size 1 (the self
    transfer narrowed and widened) equals the CPU run of the same arm,
    whose wrap onto the own rank rounds the same way."""
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.kernels import distributed as pdist

    size = {2: 256, 3: 48}[dim]
    dec, u_cpu = _mesh_of_one(dim, "periodic", size, device="cpu")
    want = pdist.run_distributed(u_cpu, dec, 6, bc="periodic", impl=impl,
                                 halo_wire="bfloat16")
    exact = pdist.run_distributed(u_cpu, dec, 6, bc="periodic", impl=impl)
    assert not torch.equal(want, exact)  # the wire rounds
    with launch.process_group("nccl"):
        got = pdist.run_distributed(u_cpu.cuda(), dec, 6, bc="periodic",
                                    impl=impl, halo_wire="bfloat16")
        assert torch.equal(got.cpu(), want)


def test_halo_sweep_at_world_size_1_on_the_card(card):
    """``halo`` through NCCL at world size 1: verified rows, 0.0 GB/s
    (an axis of one rank moves nothing), with and without a wire."""
    from tpu_comm_torch.bench.halosweep import HaloSweepConfig, run_halo_sweep

    for wire in (None, "bfloat16"):
        rows = run_halo_sweep(HaloSweepConfig(
            dim=3, mesh=(1, 1, 1), max_bytes=1 << 18, iters=4, warmup=1,
            reps=2, halo_wire=wire))
        assert [r["size"] for r in rows][0] == 16384
        for r in rows:
            assert r["platform"] == "cuda" and r["verified"] is True
            assert r["halo_gbps_per_chip"] == 0.0
            assert r.get("wire_dtype") == wire


#: every mesh arm a card run graphs: (stencil, dim, --impl, options)
GRAPH_ARMS = [
    ("star", 1, "block", {}), ("star", 2, "block", {}),
    ("star", 3, "block", {"pack": "kernel"}), ("star", 3, "stream", {}),
    ("star", 3, "overlap", {"pack": "kernel"}), ("star", 2, "torch", {}),
    ("star", 2, "partitioned", {"halo_parts": 3}),
    ("star", 1, "wave", {}), ("star", 2, "wave", {}), ("star", 3, "wave", {}),
    ("star", 2, "multi", {"t_steps": 4}), ("star", 3, "multi", {"t_steps": 2}),
    ("9pt", 2, "overlap", {}), ("9pt", 2, "block", {}), ("9pt", 2, "wave", {}),
    ("9pt", 2, "multi", {"t_steps": 4}), ("27pt", 3, "stream", {}),
    ("27pt", 3, "wave", {}), ("27pt", 3, "multi", {"t_steps": 2}),
    ("star", 2, "block", {"halo_wire": "bfloat16"}),
    ("star", 3, "wave", {"halo_wire": "bfloat16"}),
    ("star", 2, "overlap", {"halo_width": 4}),
    ("star", 3, "torch", {"halo_width": 2}),
]
GRAPH_SIZES = {1: 1 << 16, 2: 256, 3: 48}


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
@pytest.mark.parametrize("stencil,dim,impl,opts", GRAPH_ARMS)
def test_graphed_run_equals_the_eager_run(card, stencil, dim, impl, opts,
                                          bc):
    """``run_distributed`` on the card replays CUDA graphs of its steps
    (exchange through NCCL at world size 1 included); every arm's result
    equals the eager steps' bitwise, and the counters read the same
    launches. 8 steps: one graph; 136: a graph of a chunk of the trips
    (34 steps, or 34 passes or windows), replayed; both graphs in one
    cache, over its one pair of buffers."""
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.kernels import distributed as pdist, launch_wrappers
    from tpu_comm_torch.kernels.graphs import graph_chunk

    kw = dict(opts, **({"stencil": stencil} if stencil != "star" else {}))
    with launch.process_group("nccl"):
        dec, u = _mesh_of_one(dim, bc, GRAPH_SIZES[dim])
        wrappers = launch_wrappers()
        graphs = {}
        for iters in (8, 136):
            before = [w.launches for w in wrappers]
            want = pdist._run_distributed_eager(u, dec, iters, bc=bc,
                                                impl=impl, **kw)
            eager = [w.launches - b for w, b in zip(wrappers, before)]
            for _ in range(2):  # the capture's run, then a replay
                before = [w.launches for w in wrappers]
                got = pdist.run_distributed(u, dec, iters, bc=bc, impl=impl,
                                            graphs=graphs, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (iters, impl)
                assert [w.launches - b for w, b in
                        zip(wrappers, before)] == eager
            # a trip is a multi pass or a deep window of steps
            trips = iters // (opts.get("t_steps") or opts.get("halo_width")
                              or 1)
            (chain,) = [g for g in _chains(graphs)
                        if g.trips == graph_chunk(trips)]
            # the first dispatch ran eagerly and was captured
            assert chain.replays == 2 * (trips // chain.trips) - 1
        assert len(_chains(graphs)) == len(graphs) - 1 == 2
        pdist.release_graphs(graphs)


@pytest.mark.parametrize("stencil,dim,impl", [
    ("star", 2, "block"), ("star", 2, "wave"), ("star", 3, "overlap"),
    ("9pt", 2, "block"), ("star", 2, "torch")])
def test_graphed_convergence_equals_the_eager_loop(card, stencil, dim, impl):
    """The convergence loop on the card, a graph a round with the
    residual's all_reduce inside: the same rounds, residual and field as
    the eager loop."""
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.kernels import distributed as pdist

    kw = {"stencil": stencil} if stencil != "star" else {}
    with launch.process_group("nccl"):
        dec, u = _mesh_of_one(dim, "dirichlet", GRAPH_SIZES[dim])
        for tol, max_iters, every in ((1e-3, 40, 4), (0.5, 40, 3),
                                      (1e-9, 7, 7)):
            want = pdist._convergence_eager(u, dec, tol, max_iters,
                                            check_every=every, impl=impl,
                                            **kw)
            graphs = {}
            for _ in range(2):
                got = pdist.run_distributed_to_convergence(
                    u, dec, tol, max_iters, check_every=every, impl=impl,
                    graphs=graphs, **kw)
                assert got[1:] == want[1:], (tol, got[1:], want[1:])
                assert torch.equal(got[0], want[0])
            pdist.release_graphs(graphs)


def test_card_mesh_rows_say_they_ran_as_graphs(card):
    from tpu_comm_torch.bench import stencil

    common = dict(dim=2, size=256, mesh=(1, 1), bc="periodic", warmup=1,
                  reps=2, verify=True, verify_iters=3)
    row = stencil.run_distributed_bench(stencil.StencilConfig(
        iters=100, impl="block", **common))
    assert (row["dispatch"], row["graph_steps"]) == ("graph", [50, 60])
    assert row["verified"] is True
    conv = stencil.run_distributed_bench(stencil.StencilConfig(
        iters=40, tol=1e-3, check_every=5, impl="wave", **common))
    assert (conv["dispatch"], conv["graph_steps"]) == ("graph", [5])
    fused = stencil.run_distributed_bench(stencil.StencilConfig(
        iters=20, fuse_steps=10, impl="overlap", **common))
    assert (fused["dispatch"], fused["graph_steps"]) == ("graph", [10])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_bench_on_the_card(card, dtype):
    """Both arms verified, timed as graph replays; the kernel arm's
    launches are counted through the replays."""
    from tpu_comm_torch.bench.packbench import PackConfig, run_pack_bench
    from tpu_comm_torch.kernels import pack as packmod

    for impl in ("fused", "kernel"):
        before = packmod.pack_faces.launches
        row = run_pack_bench(PackConfig(impl=impl, dtype=dtype, iters=4,
                                        warmup=1, reps=2))
        assert row["platform"] == "cuda" and row["verified"] is True
        assert row["dispatch"] == "graph"
        launched = packmod.pack_faces.launches - before
        # the verify pack, then 3 calls of the 4- and the 12-pack loop
        assert launched == (1 + 3 * 16 if impl == "kernel" else 0)


@pytest.mark.parametrize("impl,opts,sends", [
    ("overlap", (), 6), ("partitioned", (("halo_parts", 2),), 12),
    ("torch", (), 6)])
def test_overlap_report_on_the_card(card, impl, opts, sends):
    """At world size 1 a periodic 3D step sends each face to its own rank
    through NCCL: the report reads the P2P ops, the NCCL kernels and a
    verdict from the trace."""
    from tpu_comm_torch.bench.overlap import analyze_overlap, audit_fused
    from tpu_comm_torch.comm import launch

    with launch.process_group("nccl"):
        dec, _ = _mesh_of_one(3, "periodic", 64)
        rep = analyze_overlap(dec, bc="periodic", impl=impl, opts=opts)
        assert (rep.platform, rep.n_permutes) == ("cuda", sends)
        assert rep.n_async_pairs >= 1
        assert isinstance(rep.scheduled_overlap, bool)
        doc = audit_fused(dec, bc="periodic", impl=impl, fuse_steps=4,
                          opts=opts)
        assert doc["n_executables"] == 1, doc
        assert doc["exchange_in_graph"] is True, doc
        assert doc["nccl_nodes"] == 4 * doc["nccl_nodes_per_trip"] > 0, doc
        assert doc["host_roundtrips_between_steps"] == 0, doc
        if impl != "partitioned":
            deep = audit_fused(dec, bc="periodic", impl=impl, fuse_steps=4,
                               halo_width=2)
            assert deep["one_exchange_per_window"] is True, deep
            assert deep["exchange_in_graph"] is True, deep
            assert deep["nccl_nodes"] == 2 * deep["nccl_nodes_per_trip"] == (
                2 * deep["nccl_nodes_per_step_reference"]), deep


#: meshes of one for the reshard arms on the card: (mesh, global shape)
RESHARD_CARD = [((1,), (1 << 20,)), ((1, 1), (1024, 1024)),
                ((1, 1, 1), (64, 64, 64))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("mesh,gshape", RESHARD_CARD)
def test_reshard_arms_at_world_size_1_graphed_and_eager(card, mesh, gshape,
                                                        dtype):
    """Both arms through NCCL at world size 1: the forward reshard is the
    block itself, bitwise, and 5 round trips replayed from a CUDA graph
    equal 5 eager round trips, bitwise."""
    from tpu_comm_torch.bench.reshard import _host_field
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.comm import reshard as rs
    from tpu_comm_torch.kernels.graphs import GraphLoop
    from tpu_comm_torch.kernels.tiling import DTYPES

    dt = DTYPES[dtype]
    plan = rs.plan_reshard(gshape, mesh, mesh, dt.itemsize)
    x = _host_field(gshape, dt).to(card)
    with launch.process_group("nccl"):
        for arm in rs.ARMS:
            out = rs.reshard_block(x, plan, arm)
            assert out.dtype == dt and torch.equal(out, x), arm

            def trip(u, arm=arm):
                return rs.reshard_block(rs.reshard_block(u, plan, arm),
                                        plan, arm)

            eager = x
            for _ in range(5):
                eager = trip(eager)
            loop = GraphLoop(trip, x)
            try:
                loop.run(5)
                got = loop.run(5).clone()  # replays of the captured graph
                assert loop.graphs[5].replays == 1
            finally:
                loop.release()
            assert torch.equal(got, eager) and torch.equal(got, x), arm


def test_reshard_bench_rows_on_the_card(card):
    from tpu_comm_torch.bench.reshard import ReshardConfig, run_reshard_bench

    rows = run_reshard_bench(ReshardConfig(
        src_mesh=(1, 1), dst_mesh=(1, 1), size=1024, iters=4, warmup=1,
        reps=2))
    assert [r["impl"] for r in rows] == ["naive", "sequential"]
    for r in rows:
        assert (r["platform"], r["verified"], r["dispatch"]) == (
            "cuda", True, "graph")
        assert r["moved_bytes"] == 0 and r["gbps_eff"] is None
        assert r["peak_live_bytes_measured"] >= 0


def test_reshard_refuses_more_ranks_than_cards(card, capsys):
    from tpu_comm_torch import cli

    n = torch.cuda.device_count() + 1
    assert cli.main(["reshard", "--src-mesh", str(n), "--dst-mesh", "1",
                     "--size", str(4 * n)]) == 2
    err = capsys.readouterr().err
    assert f"union world of {n} ranks" in err


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_attention_at_world_size_1_against_the_golden(card, impl, causal,
                                                      dtype, tol):
    """Both arms through NCCL at world size 1 against
    ``reference_attention`` on the same rounded inputs, eager and
    replayed from a CUDA graph (bitwise equal to each other)."""
    import numpy as np

    from tpu_comm_torch.bench.attention import AttnConfig, attention_inputs
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.extras import ring_attention as ra
    from tpu_comm_torch.kernels.graphs import GraphLoop

    cfg = AttnConfig(seq=512, heads=8, head_dim=64, dtype=dtype)
    q, k, v = (x.to(card) for x in attention_inputs(cfg))
    fn = ra.ring_attention if impl == "ring" else ra.ulysses_attention
    with launch.process_group("nccl"):
        out = fn(q, k, v, causal=causal)
        want = ra.reference_attention(
            *(x.float().cpu().numpy() for x in (q, k, v)), causal=causal)
        np.testing.assert_allclose(out.float().cpu().numpy(), want,
                                   atol=tol, rtol=tol)
        loop = GraphLoop(lambda x: fn(x, k, v, causal=causal), q)
        try:
            loop.run(2)
            got = loop.run(2).clone()
        finally:
            loop.release()
        eager = fn(fn(q, k, v, causal=causal), k, v, causal=causal)
        assert torch.equal(got, eager)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_attention_bench_rows_on_the_card(card, impl):
    from tpu_comm_torch.bench.attention import AttnConfig, run_attention_bench

    row = run_attention_bench(AttnConfig(
        seq=1024, heads=8, head_dim=64, impl=impl, n_devices=1, iters=4,
        warmup=1, reps=2))
    assert (row["platform"], row["verified"], row["dispatch"]) == (
        "cuda", True, "graph")
    assert row["mesh"] == [1] and row["tflops"] > 0


#: the tuned-chunk card cases: (dim, points) -> a field of the family
TUNED_FAMILIES = {(1, 0): (1 << 20,), (2, 0): (1024, 1024),
                  (3, 0): (128, 128, 128), (2, 9): (1024, 1024),
                  (3, 27): (128, 128, 128)}


#: the chunked arms a --chunk-less run takes the table's chunk for, by
#: family (the 3D waves take none)
TUNED_ARMS = {(1, 0): ("stream", "stream2", "wave"), (2, 0): ("stream",
              "wave"), (3, 0): ("stream",), (2, 9): ("stream", "wave"),
              (3, 27): ("stream",)}


@pytest.mark.parametrize("dim, points, impl", [
    (*family, impl) for family, arms in TUNED_ARMS.items() for impl in arms])
def test_tuned_chunk_run_is_bitwise_the_default_chunks(
        card, tmp_path, monkeypatch, capsys, dim, points, impl):
    """A --chunk-less run of a chunked arm takes the table's chunk
    (another than the default) and its field equals, bit for bit, the run
    at the default chunk: the chunk sets the grid, never the result."""
    import numpy as np

    from tpu_comm_torch import cli
    from tpu_comm_torch.bench.stencil import CHUNK_DEFAULTS
    from tpu_comm_torch.kernels import kernels_for, tiling

    shape = TUNED_FAMILIES[dim, points]
    default = getattr(kernels_for(dim, points), CHUNK_DEFAULTS[impl])(shape)
    chunk = max(c for c in tiling.plan_chunks(dim, shape, "float32", points,
                                              impl) if c != default)
    wl = f"stencil{dim}d" + {0: "", 9: "-9pt", 27: "-27pt"}[points]
    table = tmp_path / "t.json"
    table.write_text(json.dumps({"entries": [{
        "workload": wl, "impl": impl, "dtype": "float32",
        "platform": "cuda", "size": list(shape), "chunk": chunk,
        "gbps_eff": 1.0}]}))
    monkeypatch.setattr(tiling, "TUNED_CHUNKS_PATH", table)
    argv = ["stencil", "--dim", str(dim), "--size", str(shape[0]),
            "--impl", impl, "--iters", "6", "--warmup", "0", "--reps",
            "1", *(["--points", str(points)] if points else [])]
    rows, fields = [], []
    for extra in ([], ["--chunk", str(default)]):
        dump = tmp_path / f"u{len(rows)}.npy"
        assert cli.main(argv + extra + ["--dump", str(dump)]) == 0
        rows.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
        fields.append(np.load(dump))
    assert (rows[0]["chunk"], rows[0]["chunk_source"]) == (chunk, "tuned")
    assert (rows[1]["chunk"], rows[1]["chunk_source"]) == (default, "user")
    assert np.array_equal(fields[0].view(np.uint32),
                          fields[1].view(np.uint32))


def test_tune_on_the_card_skips_only_pre_launch_refusals(card, tmp_path,
                                                        monkeypatch):
    """The 2D grid kernel's 256-row window does not fit a CTA: refused
    before launch, a skip; every other candidate runs, verified. A fault
    at a legal chunk (here a RuntimeError) ends the sweep on the card."""
    from tpu_comm_torch.bench import stencil as pstencil
    from tpu_comm_torch.bench.tune import TuneConfig, run_tune

    cfg = TuneConfig(dim=2, size=1024, impls=("stream", "grid"),
                     chunks=(64, 256), iters=4, warmup=0, reps=1,
                     verify_iters=4, jsonl=str(tmp_path / "r.jsonl"),
                     table=None)
    summary = run_tune(cfg)
    assert [(r["impl"], r["chunk"], r["verified"], r["platform"])
            for r in summary["results"]] == [
        ("stream", 64, True, "cuda"), ("grid", 64, True, "cuda"),
        ("stream", 256, True, "cuda")]
    (skip,) = summary["skipped"]
    assert (skip["impl"], skip["chunk"]) == ("grid", 256)
    assert "shared memory" in skip["reason"]

    def broken(scfg):
        raise RuntimeError("a CUDA error")

    monkeypatch.setattr(pstencil, "run_single_device", broken)
    with pytest.raises(RuntimeError, match="a CUDA error"):
        run_tune(cfg)


def _build_cases():
    from tpu_comm_torch.bench import aot

    return {c.name: c for c in aot.kernel_cases()}


def test_build_check_reads_ok_for_every_case_on_the_card(card):
    """``bench/aot.py`` on the card's toolkit: every one of JAX's 86 cases
    builds for sm_90a and holds its instantiations, but those the port
    refuses (``aot.REFUSED``, ROADMAP.md C8)."""
    from tpu_comm_torch.bench import aot

    result = aot.compile_all_kernels()
    assert list(result) == list(_build_cases())
    for name, verdict in result.items():
        if name in aot.REFUSED:
            assert verdict.startswith("error: "), (name, verdict)
        else:
            assert verdict == "ok", (name, verdict)


@pytest.mark.parametrize("name", list(_build_cases()))
def test_every_build_case_launches_through_its_wrapper(card, name):
    """Each case on a tensor of its shape and dtype, through the wrapper
    it stands for: it launches where the build check's pre-launch checks
    pass, and the wrapper refuses it where they do not."""
    from tpu_comm_torch.bench import aot
    from tpu_comm_torch.kernels.tiling import DTYPES

    case = _build_cases()[name]
    x = _field(case.shape, DTYPES[case.dtype], seed=3)
    wrapper = getattr(case.module, aot.WRAPPERS[case.arm])
    before = wrapper.launches
    if name in aot.REFUSED:
        with pytest.raises(ValueError, match="shared memory"):
            case.run(x)
        assert wrapper.launches == before
        return
    aot.check_case(case)
    case.run(x)
    torch.cuda.synchronize()
    assert wrapper.launches > before
