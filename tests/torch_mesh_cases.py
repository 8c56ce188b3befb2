"""Cases the port's mesh tests run on spawned ranks (no test in here).

``tpu_comm_torch.comm.launch.run_ranks`` starts each rank in a fresh
interpreter, which re-imports the module its entry function lives in. So
that function, :func:`run_cases`, lives here, in a module that imports
neither JAX nor the JAX package: a rank costs one ``import torch``, and
the test files, which do import JAX for the other side of each
comparison, stay out of the ranks.

One spawn runs many cases: a test file's fixture hands :func:`run_cases`
a dict of ``name -> (kind, params)`` and gets back ``name -> [result of
rank 0, result of rank 1, ...]``; the parametrised tests then compare.
Inputs and results are NumPy arrays (bfloat16 as float32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpu_comm_torch.bench import stencil as pstencil
from tpu_comm_torch.comm import halo
from tpu_comm_torch.domain import Decomposition
from tpu_comm_torch.kernels import distributed as pdist
from tpu_comm_torch.kernels.tiling import DTYPES, to_numpy_field
from tpu_comm_torch.topo import make_cart_mesh


def _setup(p: dict):
    """This rank's mesh, decomposition and block for case params ``p``
    (``u0`` global field, ``mesh`` shape, optional ``bc``, ``dtype``)."""
    u0 = p["u0"]
    cart = make_cart_mesh(
        u0.ndim, shape=p["mesh"], periodic=p.get("bc") == "periodic"
    )
    dec = Decomposition(cart, u0.shape)
    block = dec.scatter(u0, "cpu", DTYPES[p.get("dtype", "float32")])
    return cart, dec, block


def _np(x):
    return to_numpy_field(x)


def case_run(p):
    """``run_distributed`` gathered: the global field on rank 0 (the star,
    or the box stencil ``p["stencil"]``; ``t_steps`` for ``multi``)."""
    cart, dec, block = _setup(p)
    extra = {"t_steps": p["t_steps"]} if "t_steps" in p else {}
    out = pdist.run_distributed(
        block, dec, p["iters"], bc=p["bc"], impl=p["impl"],
        pack=p.get("pack", "fused"), stencil=p.get("stencil", "star"),
        **extra,
    )
    return dec.gather(out)


def case_conv(p):
    """``run_distributed_to_convergence``: (field on rank 0, iters, res)."""
    cart, dec, block = _setup(p)
    out, it, res = pdist.run_distributed_to_convergence(
        block, dec, p["tol"], p["max_iters"], check_every=p["check_every"],
        bc=p["bc"], impl=p["impl"], stencil=p.get("stencil", "star"),
    )
    return dec.gather(out), it, res


def case_ghosts_along(p):
    cart, _, block = _setup(p)
    a = p["axis"]
    lo, hi = halo.ghosts_along(block, cart, cart.axis_names[a], a,
                               p.get("width", 1))
    return _np(lo), _np(hi)


def case_pad_halo(p):
    cart, _, block = _setup(p)
    return _np(halo.pad_halo(block, cart, width=p.get("width", 1)))


def case_assemble(p):
    """``assemble_padded`` of the parallel exchange, or of the packed 3D
    one with ``pack`` set."""
    cart, _, block = _setup(p)
    if p.get("pack"):
        ghosts = halo.exchange_ghosts_3d_packed(block, cart, p["pack"])
    else:
        ghosts = halo.exchange_ghosts(block, cart)
    return _np(halo.assemble_padded(block, ghosts))


def case_scatter_gather(p):
    """(this rank's coords, offset and block, the gathered field)."""
    cart, dec, block = _setup(p)
    return (cart.coords, dec.global_offset(cart.coords), _np(block),
            dec.gather(block))


def case_freeze(p):
    """``dirichlet_freeze`` against its mask form on this rank."""
    cart, _, block = _setup(p)
    new = torch.full_like(block, -1.0)
    mask = pdist.ring_mask_padded(block.shape, cart)
    want = torch.where(mask, block, new)
    got = pdist.dirichlet_freeze(new, block, cart)
    return bool(torch.equal(got, want)), int(mask.sum())


def case_verdict(p):
    """``_collective_verdict`` with a check that fails on rank 0 only:
    what every rank raised."""
    def check():
        raise AssertionError("verification FAILED: injected")

    try:
        pstencil._collective_verdict(check, "cpu")
    except AssertionError as e:
        return str(e)
    return None


def case_bench(p):
    """``run_distributed_bench`` from inside the group: its row on rank
    0."""
    return pstencil.run_distributed_bench(pstencil.StencilConfig(**p))


KINDS = {
    "run": case_run,
    "conv": case_conv,
    "ghosts_along": case_ghosts_along,
    "pad_halo": case_pad_halo,
    "assemble": case_assemble,
    "scatter_gather": case_scatter_gather,
    "freeze": case_freeze,
    "verdict": case_verdict,
    "bench": case_bench,
}


def run_cases(cases: dict) -> dict | None:
    """Run every case on this rank; on rank 0 return ``name -> list of
    the ranks' results`` (None elsewhere). A case that raises the same
    error on every rank is recorded as that ``Exception`` instance."""
    world = dist.get_world_size()
    out = {}
    for name, (kind, params) in cases.items():
        try:
            result = KINDS[kind](params)
        except ValueError as e:  # the same check fails on every rank
            result = e
        gathered = [None] * world if dist.get_rank() == 0 else None
        dist.gather_object(result, gathered, dst=0)
        out[name] = gathered
    return out if dist.get_rank() == 0 else None


def fail_on_rank(rank: int):
    """Entry point for the launcher's own test: ``rank`` raises while the
    others wait in a collective."""
    if dist.get_rank() == rank:
        raise ValueError(f"injected failure on rank {rank}")
    dist.barrier()


def hang_forever():
    """Entry point for the launcher's time-limit test."""
    import time

    time.sleep(3600)


def field(shape, seed: int, kind: str = "random") -> np.ndarray:
    """The seeded global field both packages start from."""
    from tpu_comm_torch.kernels.reference import init_field

    return init_field(tuple(shape), np.float32, kind=kind, seed=seed)
