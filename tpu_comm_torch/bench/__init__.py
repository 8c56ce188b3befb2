"""Benchmark drivers of the port (``tpu_comm/bench`` counterparts).

The collective sweep's op names and the reshard arms (the port's copies
of ``tpu_comm/bench/__init__.py`` ``SWEEP_OPS`` and ``RESHARD_IMPLS``;
none names a Pallas arm, so they keep the JAX package's names). The
STREAM quartet's names (the port's copies of
``tpu_comm/bench/__init__.py`` ``MEMBW_OPS`` and of
``tpu_comm/bench/membw.py`` ``TRAFFIC``) and the port's membw arm names.
The JAX package names the arms after Pallas; the port names them after
what they run:

    JAX           port
    lax           torch     one PyTorch op per pass (not a kernel)
    pallas        chunked   csrc/membw.cu membw_unary / membw_binary
    pallas-stream stream    csrc/membw.cu membw_stream (copy only)
    pallas-dma    dma       csrc/membw.cu membw_dma (copy only)
    both          both      chunked + torch

The stencil driver's arms follow the same rule (``overlap`` keeps its
name: it names no Pallas kernel):

    JAX            port
    lax            torch    plain PyTorch in the field's dtype, on the
                            ghost-padded block (mesh) or the field (one
                            device)
    overlap        overlap  interior/boundary split in plain PyTorch (mesh)
    pallas         block    csrc/jacobi_block.cu (mesh and one device)
    pallas-stream  stream   csrc/jacobi_stream.cu (mesh and one device)
    pallas-stream2 stream2  csrc/jacobi_stream.cu, its column-strip carry
                            form (1D, one device)
    pallas-grid    grid     csrc/grid.cu, a window a CTA (1D, 2D, one
                            device)
    pallas-wave    wave     csrc/wave.cu, ring-buffered block streams
                            (mesh and one device; mesh: every bc, one
                            device: dirichlet)
    pallas-multi   multi    csrc/multi.cu, t steps a pass (one device)
    multi          multi    width-t ghosts, t steps an exchange (mesh)
    partitioned    partitioned  overlap, each face sent as sub-slabs
                            (mesh)
    --pack fused  fused     slice copies of the faces
    --pack pallas kernel    csrc/pack.cu pack_faces_kernel (3D mesh)

In both modes ``multi`` means t steps per pass (one device) or per
exchange (mesh). A JAX name is refused with an error that names the
port's arm; there are no aliases.
"""

SWEEP_OPS = (
    "allreduce",        # native all_reduce
    "allreduce-ring",   # explicit point-to-point ring (RS+AG)
    "rs-ag",            # native reduce_scatter + all_gather pair
    "ppermute",         # one-hop ring shift (the halo primitive)
    "bcast",            # mask+all_reduce formulation
    "bcast-tree",       # explicit binomial tree
    "all-to-all",       # full transpose (the Ulysses/SP resharding primitive)
)
#: ``reshard``'s arms (``comm/reshard.py`` ``ARMS``, then "both"; the
#: JAX package's names: neither names a Pallas arm)
RESHARD_IMPLS = ("naive", "sequential", "both")
MEMBW_OPS = ("copy", "scale", "add", "triad")
#: element visits (reads + writes) per iteration, STREAM convention
TRAFFIC = {"copy": 2, "scale": 2, "add": 3, "triad": 3}
MEMBW_IMPLS = ("torch", "chunked", "stream", "dma")
#: the JAX package's arm name -> the port's
JAX_MEMBW_IMPLS = {
    "lax": "torch",
    "pallas": "chunked",
    "pallas-stream": "stream",
    "pallas-dma": "dma",
}
#: the JAX package's stencil arm name -> the port's
JAX_STENCIL_IMPLS = {
    "lax": "torch",
    "pallas": "block",
    "pallas-stream": "stream",
    "pallas-stream2": "stream2",
    "pallas-grid": "grid",
    "pallas-wave": "wave",
    "pallas-multi": "multi",
}
#: the JAX package's ``--pack`` name -> the port's
JAX_STENCIL_PACKS = {"pallas": "kernel"}
