"""Cases the port's overlap and pack tests run on spawned ranks (no test
in here; jax-free, as ``torch_mesh_cases``, whose runner it uses).

- ``analyze``: ``bench.overlap.analyze_overlap`` on this rank's mesh, its
  report as a dict;
- ``audit``: ``bench.overlap.audit_fused``;
- ``roundtrip``: a 3D block's faces packed (``pack_faces_3d``), exchanged
  (``halo.start_exchange_ghosts_3d_packed``) and unpacked into the
  zero-padded block (``pack.unpack_ghosts_3d``): the padded array, and
  whether it equals ``halo.assemble_padded`` of the same ghosts.
"""

from __future__ import annotations

import torch

import torch_mesh_cases as mesh_cases
from tpu_comm_torch.bench import overlap as poverlap
from tpu_comm_torch.comm import halo
from tpu_comm_torch.kernels import pack as ppack
from tpu_comm_torch.kernels.tiling import to_numpy_field


def _dec(p):
    from tpu_comm_torch.domain import Decomposition
    from tpu_comm_torch.topo import make_cart_mesh

    cart = make_cart_mesh(len(p["mesh"]), shape=p["mesh"],
                          periodic=p["bc"] == "periodic")
    return Decomposition(
        cart, poverlap.round_global_shape(p.get("size", 64), cart.shape))


def case_analyze(p):
    return poverlap.analyze_overlap(
        _dec(p), bc=p["bc"], impl=p["impl"], opts=p.get("opts", ()),
        backend="cpu").to_dict()


def case_audit(p):
    return poverlap.audit_fused(
        _dec(p), bc=p["bc"], impl=p["impl"], fuse_steps=p["fuse_steps"],
        opts=p.get("opts", ()), halo_width=p.get("halo_width"),
        backend="cpu")


def case_roundtrip(p):
    _, dec, block = mesh_cases._setup(p)
    ghosts = halo.start_exchange_ghosts_3d_packed(
        block, dec.cart, p["pack"]).wait()
    faces = [g.squeeze(a) for a, lo, hi in ghosts for g in (lo, hi)]
    got = ppack.unpack_ghosts_3d(ppack.pad_block_3d(block), faces)
    want = halo.assemble_padded(block, ghosts)
    return to_numpy_field(got), bool(torch.equal(got, want))


KINDS = {**mesh_cases.KINDS, "analyze": case_analyze, "audit": case_audit,
         "roundtrip": case_roundtrip}


def run_cases(cases: dict) -> dict | None:
    """``torch_mesh_cases.run_cases`` over this module's kinds."""
    return mesh_cases.run_cases(cases, KINDS)
