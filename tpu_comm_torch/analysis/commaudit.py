"""The reshard arms' wire edges (the port's copy of
``tpu_comm/analysis/commaudit.py`` ``reshard_edges``).

The topology planner (``comm/topoplan.py``) scores a reshard arm by
summing these edges with :func:`comm.patterns.wire_total`. The rest of
JAX's communication audit (the edge conservation checks of every halo
arm) is not ported yet.
"""

from __future__ import annotations

from tpu_comm_torch.comm import patterns
from tpu_comm_torch.comm.reshard import ARMS, ReshardPlan


def reshard_edges(plan: ReshardPlan, arm: str) -> list[patterns.Edge]:
    """The wire edges one reshard dispatches under ``arm``: the naive
    arm's ring all-gather of the source blocks, or one edge a rank for
    every nonempty ring distance of the sequential arm (a step of
    distance 0 is a local copy and crosses no link)."""
    n = plan.n_world
    if arm == "naive":
        block = 1
        for v in plan.src_local:
            block *= v
        return patterns.ring_allgather_edges(n, block * plan.itemsize)
    if arm == "sequential":
        edges = []
        for st in plan.steps:
            if not st.k:
                continue
            slab = 1
            for v in st.slab:
                slab *= v
            for s in range(n):
                edges.append(patterns.Edge(
                    s, (s + st.k) % n, slab * plan.itemsize,
                    axis=0, direction=st.k,
                ))
        return edges
    raise ValueError(f"unknown reshard arm {arm!r} (use {ARMS})")
