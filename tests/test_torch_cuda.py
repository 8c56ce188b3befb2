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
        want = pdist.run_distributed(u, dec, 20, bc="periodic", impl=impl)
        eager = [w.launches - b for w, b in zip(wrappers, before)]
        for fuse in (20, 5):
            graphs = {}
            before = [w.launches for w in wrappers]
            got, n = pdist.run_distributed_fused(
                u, dec, 20, fuse, bc="periodic", impl=impl, graphs=graphs)
            torch.cuda.synchronize()
            (chain,) = graphs.values()
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
