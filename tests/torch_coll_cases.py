"""Cases the port's collective and sweep tests run on spawned ranks (no
test in here).

As ``torch_mesh_cases.py``: ``tpu_comm_torch.comm.launch.run_ranks``
starts each rank in a fresh interpreter that re-imports this module, so
it imports neither JAX nor the JAX package. A test file's fixture hands
:func:`run_cases` a dict of ``name -> (kind, params)`` and gets back
``name -> [result of rank 0, result of rank 1, ...]``.

Inputs are the global float32 NumPy array JAX shards over its mesh axis:
rank i takes block i of the leading axis, narrowed to ``dtype`` by torch
(bfloat16 rounds to nearest even, as JAX's cast). Results are NumPy
arrays (bfloat16 widened to float32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

import torch_mesh_cases
from tpu_comm_torch.bench import sweep as psweep
from tpu_comm_torch.comm import collectives as coll
from tpu_comm_torch.kernels.tiling import DTYPES, to_numpy_field
from torch_fake_clock import fake_clock


def _dtype(name):
    return None if name is None else DTYPES[name]


def block_of(host: np.ndarray, dtype: str) -> torch.Tensor:
    """This rank's block of ``host`` in ``dtype``."""
    n, rank = dist.get_world_size(), dist.get_rank()
    per = host.shape[0] // n
    return torch.from_numpy(host[rank * per:(rank + 1) * per].copy()).to(
        DTYPES[dtype])


def case_coll(p):
    """``collectives.<fn>`` on this rank's block, with ``kwargs`` (dtype
    arguments by name)."""
    kwargs = dict(p.get("kwargs", {}))
    for key in ("wire_dtype", "acc_dtype", "compute_dtype"):
        if key in kwargs:
            kwargs[key] = _dtype(kwargs[key])
    x = block_of(p["host"], p["dtype"])
    before = x.clone()
    out = getattr(coll, p["fn"])(x, **kwargs)
    # no collective writes into its input
    assert torch.equal(x, before)
    return to_numpy_field(out)


def case_body(p):
    """One application of the sweep's chained body of ``op``."""
    body = psweep._loop_body(p["op"], dist.get_world_size(),
                             _dtype(p.get("wire_dtype")),
                             _dtype(p.get("acc_dtype")))
    return to_numpy_field(body(block_of(p["host"], p["dtype"])))


def case_sweep(p):
    """``run_sweep`` from inside the group, on this rank's fake clock
    (``torch_fake_clock``): its rows on rank 0."""
    with fake_clock():
        return psweep.run_sweep(psweep.SweepConfig(**p))


def case_planned_sweep(p):
    """``case_sweep`` of ``p["cfg"]`` under the topo plan ``p["doc"]`` (an
    artifact, or ``"0"``)."""
    with torch_mesh_cases.topo_plan(p["doc"]):
        return case_sweep(p["cfg"])


def case_subgroup(p):
    """``collectives.<fn>`` over the group of ranks ``p["ranks"]``
    (``root`` a rank of that group): what each member returns, None on
    the other ranks. Every rank creates the group, as ``new_group``
    needs."""
    group = dist.new_group(p["ranks"])
    if dist.get_rank() not in p["ranks"]:
        return None
    n, i = len(p["ranks"]), p["ranks"].index(dist.get_rank())
    per = p["host"].shape[0] // n
    x = torch.from_numpy(p["host"][i * per:(i + 1) * per].copy())
    return to_numpy_field(getattr(coll, p["fn"])(x, group, **p["kwargs"]))


KINDS = {"coll": case_coll, "body": case_body, "sweep": case_sweep,
         "subgroup": case_subgroup, "planned_sweep": case_planned_sweep}


def run_cases(cases: dict) -> dict | None:
    """``torch_mesh_cases.run_cases`` over this module's kinds."""
    return torch_mesh_cases.run_cases(cases, KINDS)
