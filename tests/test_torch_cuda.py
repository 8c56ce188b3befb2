"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip where no CUDA device is present. This file
imports no JAX (the card's machine has none); run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX).
"""

import pytest
import torch

from tpu_comm_torch.kernels import jacobi1d, jacobi2d, jacobi3d, run_steps

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
