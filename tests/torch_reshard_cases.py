"""Cases the port's reshard and attention tests run on spawned ranks (no
test in here).

As ``torch_coll_cases.py``: ``tpu_comm_torch.comm.launch.run_ranks``
starts each rank in a fresh interpreter that re-imports this module, so
it imports neither JAX nor the JAX package. A test file's fixture hands
:func:`run_cases` a dict of ``name -> (kind, params)`` and gets back
``name -> [result of rank 0, result of rank 1, ...]``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

import torch_mesh_cases
from tpu_comm_torch.bench import attention as pattn
from tpu_comm_torch.bench import reshard as pbench
from tpu_comm_torch.comm import reshard as rs
from tpu_comm_torch.extras import ring_attention as ra
from tpu_comm_torch.kernels.tiling import DTYPES, to_numpy_field
from torch_fake_clock import fake_clock


def case_reshard(p):
    """``reshard_block`` of this rank's block of the position-coded field
    (``bench/reshard.py`` ``_host_field``; zeros outside the source
    mesh): the output's bit patterns."""
    dtype = DTYPES[p["dtype"]]
    plan = rs.plan_reshard(p["gshape"], p["src"], p["dst"], dtype.itemsize)
    rank = dist.get_rank()
    g = pbench._host_field(plan.global_shape, dtype)
    block = (g[rs._block_slices(rank, plan.src_mesh, plan.src_local)]
             .contiguous() if rank < plan.n_src
             else torch.zeros(plan.src_local, dtype=dtype))
    before = block.clone()
    out = rs.reshard_block(block, plan, p["arm"])
    # the input is only read
    assert torch.equal(block, before)
    return pbench._bits(out)


def case_attention(p):
    """``run_ring_attention`` of the global float32 ``q``, ``k``, ``v``
    narrowed to ``dtype``: the global result (float32) on rank 0."""
    q, k, v = (torch.from_numpy(x).to(DTYPES[p["dtype"]])
               for x in (p["q"], p["k"], p["v"]))
    out = ra.run_ring_attention(q, k, v, causal=p["causal"], impl=p["impl"])
    return None if out is None else to_numpy_field(out)


def case_reshard_bench(p):
    """``run_reshard_bench`` from inside the group, on this rank's fake
    clock (``torch_fake_clock``): its rows on rank 0."""
    with fake_clock():
        return pbench.run_reshard_bench(pbench.ReshardConfig(**p))


def case_attention_bench(p):
    """``run_attention_bench`` from inside the group, on this rank's fake
    clock: its row on rank 0."""
    with fake_clock():
        return pattn.run_attention_bench(pattn.AttnConfig(**p))


KINDS = {"reshard": case_reshard, "attention": case_attention,
         "reshard_bench": case_reshard_bench,
         "attention_bench": case_attention_bench}


def run_cases(cases: dict) -> dict | None:
    """``torch_mesh_cases.run_cases`` over this module's kinds."""
    return torch_mesh_cases.run_cases(cases, KINDS)
