"""Cases the halo-sweep and fused-chain tests run on spawned ranks (no
test in here; jax-free, as ``torch_mesh_cases`` explains).

:func:`run_cases` runs ``torch_mesh_cases.run_cases`` with this module's
kinds added: the wire and partitioned exchanges, the distributed step
with every shaping option, the fused chain, the halo loop and the two
sweeps' entry points from inside the group.
"""

from __future__ import annotations

import torch

import torch_mesh_cases as mesh_cases
from tpu_comm_torch.bench import halosweep as phalo
from tpu_comm_torch.comm import halo
from tpu_comm_torch.kernels import distributed as pdist

_setup, _np = mesh_cases._setup, mesh_cases._np


def case_exchange(p):
    """The parallel (``parts`` absent) or partitioned exchange's ghosts,
    each widened back from the wire ``p["wire"]``: ``[(axis, lo, hi)]``
    and whether every ghost came back in the block's dtype."""
    cart, _, block = _setup(p)
    wire = p.get("wire")
    if "parts" in p:
        ghosts = halo.exchange_ghosts_partitioned(
            block, cart, parts=p["parts"], width=p.get("width", 1),
            wire_dtype=wire)
    else:
        ghosts = halo.exchange_ghosts(block, cart, width=p.get("width", 1),
                                      wire_dtype=wire)
    same = all(g.dtype == block.dtype for _, lo, hi in ghosts
               for g in (lo, hi))
    return [(a, _np(lo), _np(hi)) for a, lo, hi in ghosts], same


def case_pad_halo_wire(p):
    """``pad_halo`` (the chained exchange) with a wire."""
    cart, _, block = _setup(p)
    return _np(halo.pad_halo(block, cart, width=p.get("width", 1),
                             wire_dtype=p["wire"]))


def case_dist(p):
    """``run_distributed`` gathered, with any options in ``p["opts"]``."""
    cart, dec, block = _setup(p)
    out = pdist.run_distributed(block, dec, p["iters"], bc=p["bc"],
                                impl=p["impl"], **p.get("opts", {}))
    return dec.gather(out)


def case_fused(p):
    """``run_distributed_fused`` gathered: (field, dispatches, whether
    the caller's block is unchanged)."""
    cart, dec, block = _setup(p)
    keep = block.clone()
    out, n = pdist.run_distributed_fused(
        block, dec, p["iters"], p["fuse_steps"], bc=p["bc"], impl=p["impl"],
        **p.get("opts", {}))
    return dec.gather(out), n, bool(torch.equal(block, keep))


def case_halo_loop(p):
    """``halosweep.halo_loop`` gathered (the block is only read)."""
    cart, dec, block = _setup(p)
    keep = block.clone()
    out = phalo.halo_loop(block, cart, p["iters"], p["width"], p.get("wire"))
    return dec.gather(out), bool(torch.equal(block, keep))


def case_halo_sweep(p):
    """``run_halo_sweep`` from inside the group: its rows on rank 0."""
    return phalo.run_halo_sweep(phalo.HaloSweepConfig(**p))


def case_deep_sweep(p):
    """``run_deep_halo_sweep`` from inside the group."""
    return phalo.run_deep_halo_sweep(phalo.DeepHaloSweepConfig(**p))


KINDS = {
    **mesh_cases.KINDS,
    "exchange": case_exchange,
    "pad_halo_wire": case_pad_halo_wire,
    "dist": case_dist,
    "fused": case_fused,
    "halo_loop": case_halo_loop,
    "halo_sweep": case_halo_sweep,
    "deep_sweep": case_deep_sweep,
}


def run_cases(cases: dict) -> dict | None:
    """``torch_mesh_cases.run_cases`` over this module's kinds."""
    return mesh_cases.run_cases(cases, KINDS)
