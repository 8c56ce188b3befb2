#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_comm_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. environment: torch/CUDA versions, device count, ``nvidia-smi`` name and
   power limit;
2. build: the CUDA kernels from ``tpu_comm_torch/csrc`` into
   ``build/torch_ext/`` (one ``nvcc`` per source, all at once; timed);
3. every kernel against its plain PyTorch version on the card, required
   bitwise equal (``torch.equal``):
   - stencils, the stream and the block kernels of the star (1D, 2D, 3D)
     and of the box stencils (2D 9-point, 3D 27-point), the grid kernels
     of the 1D and 2D star, the wave kernels of the 1D and 2D star and of
     both boxes, and the 1D stream kernel's carry form (stream2): kernel
     x {float32, bfloat16, float16} x {dirichlet, periodic} (wave:
     dirichlet, and its refusal of periodic asserted), 20 steps at full
     size, plus ragged shapes and (every chunked arm) a non-default chunk;
   - temporal blocking, the multi kernels of the 1D and 2D star and the
     9-point box and the 3D wavefront (dirichlet only, t = 4 a pass):
     every dtype x bc at full size over 3 passes of t = 8,
     t = 1 (in float32 also equal to one step of the block kernel), a t
     above the kernel's most steps a launch (chained sub-passes), ragged
     shapes and non-default tiles; for the 2D and 3D kernels also every t
     a launch takes at full size and views off the 16-byte grid; and
     (``cuobjdump``) no instantiation of the 2D or 3D multi kernel spills
     to local memory, and the 2D one keeps its 128-bit accesses;
   - the ghost-fed wave kernels of the mesh wave arm (1D, 2D star): 20
     chained steps with fresh random ghost lines each step, every dtype,
     at full size, ragged and tiny shapes (one cell, one row, one
     column), a non-default chunk, and the wrappers' refusal of a bad
     ghost or an aliased output;
   - the face pack: the four packed faces x every dtype at 512^3, at
     ragged shapes, at a block for each path of the kernel (y rows as
     16-byte vectors and cell by cell, nx = 1, ny = 1, nz > 65535) and
     on views off the 16-byte grid;
   - membw: every op a kernel serves x every dtype x aliased on/off x the
     default and a non-default chunk, at 2^26 elements and at a ragged
     size; the stream copy also on an offset view off the 16-byte grid
     (its scalar form) at both sizes and on 1024-cell views; the dma copy
     at every depth 2-8, also with fewer chunks than slots on the card and
     per CTA; and each of the exact set of stream-copy instantiations
     must still hold its neighbour loads in its machine code
     (``cuobjdump``);
4. the main path, in process through ``cli.main``, each run with every
   kernel's launch count set to 0 just before and read just after:
   ``stencil --impl auto --verify`` for dims 1, 2 and 3 at full size, the
   box stencils ``stencil --points 9 --dim 2`` and ``--points 27 --dim 3``
   with ``--impl auto``, ``--impl block`` and ``--impl wave``, ``--impl
   grid``, ``wave`` and ``torch`` in 1D and 2D and ``--impl stream2`` in
   1D (a ``torch`` run launches no kernel), ``membw --op OP --impl
   ARM`` for every (op, arm) pair the JAX CLI accepts, and the mesh runs
   ``stencil --mesh 1[,1[,1]]`` (world size 1, the NCCL group created; a
   periodic axis exchanges with its own rank through NCCL; every run's
   loops replayed from CUDA graphs, its row saying ``dispatch: graph``
   and the steps a graph holds) for the block
   arm in 1D, 2D and 3D and the stream, overlap and auto arms in 3D, the
   3D ones with ``--pack kernel``, and for the box stencils (the chained
   exchange, one NCCL batch per axis) the block, stream and overlap arms
   of ``--points 9`` and the block and stream arms of ``--points 27``,
   and the wave arm of every stencil (the ghost-fed kernels in 1D and 2D,
   the wavefront at t = 1 in 3D, the box waves; each launched once a
   step), each dirichlet and periodic, plus two star (block, wave) and
   one ``--points 9`` ``--tol`` run whose residual goes through
   ``all_reduce``; temporal
   blocking: ``stencil --impl multi --t-steps 8 --iters 96`` for the 1D
   and 2D star and ``--points 9`` and ``--t-steps 4`` (dirichlet) for the
   3D star at full size (its kernel launched once a pass, and no other),
   and on a mesh of one ``--impl multi --t-steps 4`` (the width-4 chained
   exchange, no kernel) for the star in 1D, 2D,
   3D and both boxes, each bc (the 512^3 ones unverified: their goldens
   cost a minute); each row must say ``platform: cuda`` and
   ``verified: true``, the run's kernels must have launched and no
   other; the collective sweep at world size 1 (NCCL), ``sweep --op OP
   --n-devices 1`` for every op (1 KiB-64 MiB) and ``allreduce-ring
   --wire-dtype bfloat16 --acc-dtype float32``, and ``allreduce`` to
   1 GiB: every row ``platform: cuda``, ``verified: true``, ``mesh:
   [1]``, ``gbps_bus: 0.0``, and no kernel of the port launched; and
   one profiled mesh run, ``stencil --dim 3 --mesh 1,1,1 --impl block
   --pack kernel --bc periodic --iters 20 --profile DIR`` (and the same
   run without ``--profile``, for the cost of the trace), whose trace
   must hold the block kernel and an NCCL kernel; its ten device ops
   that took the most time are printed with their counts; the halo
   microbench, ``halo --mesh 1[,1[,1]]`` for dims 1-3 (16 KiB-64 MiB a
   rank, periodic: the NCCL self-exchange's cost a step, 0.0 GB/s), 3D
   also ``--width 2`` and ``--halo-wire bfloat16``; the same 3D block
   step unfused and as ``--fuse-sweep 1,20`` (each dispatch a CUDA
   graph replay; every kernel's launches, replays included, equal the
   eager run's a step times the run's steps), ``--impl partitioned
   --halo-parts 4`` (2D), ``--halo-wire bfloat16`` for the block (2D,
   3D ``--pack kernel``), wave (2D) and multi (3D) arms, and
   ``halosweep --widths 1,2,4,8`` (its summary line printed); and the
   graph card check: a 20-step chain of the 3D block and stream steps
   replayed from its CUDA graph, bitwise equal to the eager chain, its
   launches a replay those of the capture and of the eager chain; the
   ``--tol`` runs' convergence loop (a graph a round, the residual's
   ``all_reduce`` inside) held to the eager loop at full size: the same
   rounds as the CLI row's, residual and field bitwise; the ``overlap``
   subcommand on a periodic 512^3 mesh of one (``--impl overlap``,
   ``partitioned --halo-parts 4``, and the fused audits ``--fuse-steps
   20`` with and without ``--halo-width 4``: P2P ops a step, NCCL
   kernels, a verdict, one graph launch a dispatch holding the
   exchanges); and ``pack --impl both`` at JAX's default block and at
   512^3, verified, timed as graph replays, its kernel arm's launches
   counted; ``reshard --impl both`` on a mesh of one at the stencils'
   main-path sizes (1D 2^26, 2D 8192^2, 3D 512^3, float32) and at JAX's
   default 2D size (1024) in bfloat16: both rows verified bitwise against
   the oracle, timed as graph replays, each row's
   ``peak_live_bytes_measured`` printed beside the model's
   ``peak_live_bytes``, and each arm's CUDA graph of round trips bitwise
   equal to the same round trips launched eagerly; and ``attention`` at
   JAX's defaults (seq 4096, 8 heads, head_dim 128) on a ring of one:
   ring and Ulysses, each causal and not, and ring in bfloat16, verified
   against the NumPy golden, timed as graph replays, their TFLOP/s
   printed (neither family runs a kernel of the port: none may launch);
5. times at the full float32 sizes (CUDA events): kernel, plain version,
   one library call computing the same function (a yardstick the port
   never calls), and for each stencil a device-to-device ``copy_`` and the
   port's own chunked copy kernel at the same bytes; and per mesh arm
   (every arm, the star in 1D-3D and both box stencils, with
   ``partitioned``, ``--halo-width`` and ``--halo-wire``) the whole
   distributed step (exchange, kernel, face recompute, freeze) eager,
   one call a step, beside the same step replayed from a CUDA graph of
   20 steps, in turns, the graph's chain bitwise equal to the eager
   one, and beside them its kernel alone and its exchange alone; for the
   multi kernels the time per pass of t = 8,
   its bound, and a circular convolution with the t-fold stencil as the
   library call (t = 4 for the 3D wavefront, also timed at t = 1, 2,
   8), the pass timed in turns beside the block kernel called t times
   and ``copy_`` (the 3D wavefront also at t = 1 beside one block step);
   for the mesh ``multi`` arm one pass divided by t beside the block
   arm's step; the ghost-fed wave kernels with a convolution of the
   ghost-padded block as the library call; the mesh wave arm's step of
   every stencil beside its kernel and its exchange; the face pack in
   turns (device time queued, and the wrapper's back-to-back call time),
   also on a cold L2 and at narrower rows, and the 3D
   block step on a mesh of one with ``--pack kernel`` and ``--pack
   fused`` in turns with each other; and the reshard round trip of each
   arm (8192^2, float32) and the float32 ring attention at JAX's
   defaults, eager beside a CUDA graph of 10 iterations, in turns;
6. the script's time, the ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, ...}`` line.

Phase 5 also times the grid, wave and stream2 kernels like the other
single-device stencils (``measure_times``), each grid and wave kernel
also at other chunks (ring blocks, or the 27-point wave's tile rows); and
the membw copies in turns with ``copy_`` (``in_turns``: the median of
three runs and their spread) in float32 and bfloat16, in float32 beside
the 1D stream and stream2 stencil kernels, the stream copy's other forms
and chunks, and the dma ring's sweep of slot sizes and depths.

Full sizes: stencils 1D 2^26 points, 2D 8192^2, 3D 512^3 (the box
stencils too); membw 2^26 elements. In float32 that is 256/256/512 MiB
per buffer, far above the 50 MB L2, so the kernels stream DRAM; the mesh
runs of phase 4 are at the same global sizes. Inputs are made on the card
from fixed seeds. Phase 4's runs of one stencil share its NumPy golden
(:func:`share_goldens`).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIZES = {1: 1 << 26, 2: 8192, 3: 512}
CHECK_STEPS = 20
VERIFY_ITERS = 4
#: H100 SXM HBM3 rate (NVIDIA data sheet), the bytes bound's denominator
PEAK_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12
#: a stencil's key: the star's dim (1, 2, 3) or the box's ``--points``
#: (9, 27) -> the field's dim
DIM = {1: 1, 2: 2, 3: 3, 9: 2, 27: 3}
BOX = (9, 27)
#: per output element: the adds and the one multiply of the update (the
#: golden's: one add fewer than the neighbours, then the multiply)
OPS_PER_POINT = {1: 2, 2: 4, 3: 6, 9: 8, 27: 26}
#: stencil arm -> key -> (kernel, the TPU kernel body it replaces)
KERNELS = {
    "stream": {
        1: ("jacobi1d_stream", "tpu_comm/kernels/jacobi1d.py:318"),
        2: ("jacobi2d_stream", "tpu_comm/kernels/jacobi2d.py:293"),
        3: ("jacobi3d_stream", "tpu_comm/kernels/jacobi3d.py:153"),
        9: ("stencil9_stream", "tpu_comm/kernels/stencil9.py:112"),
        27: ("stencil27_stream", "tpu_comm/kernels/stencil27.py:168"),
    },
    "block": {
        1: ("jacobi1d_block", "tpu_comm/kernels/jacobi1d.py:139"),
        2: ("jacobi2d_block", "tpu_comm/kernels/jacobi2d.py:147"),
        3: ("jacobi3d_block", "tpu_comm/kernels/jacobi3d.py:108"),
        9: ("stencil9_block", "tpu_comm/kernels/stencil9.py:79"),
        27: ("stencil27_block", "tpu_comm/kernels/stencil27.py:105"),
    },
    "grid": {
        1: ("jacobi1d_grid", "tpu_comm/kernels/jacobi1d.py:174"),
        2: ("jacobi2d_grid", "tpu_comm/kernels/jacobi2d.py:189"),
    },
    "wave": {
        1: ("jacobi1d_wave", "tpu_comm/kernels/jacobi1d.py:558"),
        2: ("jacobi2d_wave", "tpu_comm/kernels/jacobi2d.py:517"),
        9: ("stencil9_wave", "tpu_comm/kernels/stencil9.py:272"),
        27: ("stencil27_wave", "tpu_comm/kernels/stencil27.py:246"),
    },
    "stream2": {
        1: ("jacobi1d_stream2", "tpu_comm/kernels/jacobi1d.py:318"),
    },
}
SOURCES = {"stream": "tpu_comm_torch/csrc/jacobi_stream.cu",
           "block": "tpu_comm_torch/csrc/jacobi_block.cu",
           "grid": "tpu_comm_torch/csrc/grid.cu",
           "wave": "tpu_comm_torch/csrc/wave.cu",
           "stream2": "tpu_comm_torch/csrc/jacobi_stream.cu"}
#: the bcs each arm runs (wave: dirichlet only, as JAX's pallas-wave)
ARM_BCS = {"wave": ("dirichlet",)}
#: the chunks phase 5 also times the grid and wave kernels at (float32,
#: dirichlet), beside their defaults: rows of 128 cells (1D), tile rows
#: or ring-block rows (2D, 9-point), tile rows (27-point)
CHUNK_SWEEP = {"grid": {1: (16, 32, 128), 2: (16, 64)},
               "wave": {1: (8, 32), 2: (4, 16), 9: (4, 16), 27: (4, 16)}}
BOX_SOURCE = "tpu_comm_torch/csrc/box.cu"
#: the single-device runs of phase 4: (key, --impl)
MAIN_RUNS = [(1, "auto"), (2, "auto"), (3, "auto"), (9, "auto"),
             (9, "block"), (27, "auto"), (27, "block"), (1, "grid"),
             (2, "grid"), (1, "wave"), (2, "wave"), (9, "wave"),
             (27, "wave"), (1, "stream2"), (1, "torch"), (2, "torch")]
PACK_KERNEL = ("pack_faces", "tpu_comm/kernels/pack.py:48")
PACK_SOURCE = "tpu_comm_torch/csrc/pack.cu"
PACK_RAGGED = [(1, 1, 1), (3, 5, 7), (19, 23, 45), (130, 9, 33)]
#: a block for each path of the kernel: y rows as 16-byte vectors (one
#: and several a row), y rows cell by cell (34 cells a row), nx = 1,
#: ny = 1, and nz above grid.y's 65535 (cell by cell and vectors)
PACK_PATHS = [(5, 7, 64), (3, 4, 8), (4, 6, 34), (7, 300, 1), (9, 1, 300),
              (70000, 3, 5), (66000, 2, 8)]
#: blocks packed from a view one cell past a 16-byte aligned base: the
#: y rows cell by cell though their length is whole vectors
PACK_OFF_GRID = [(64, 64, 64), (SIZES[3],) * 3]
#: DRAM sector: what one x-face element costs to read (one per row of nx)
SECTOR_BYTES = 32
#: the mesh runs of phase 4: (key, --impl, --pack), each in both bc
MESH_RUNS = [(1, "block", "fused"), (2, "block", "fused"),
             (3, "block", "kernel"), (3, "stream", "kernel"),
             (3, "overlap", "kernel"), (3, "auto", "fused"),
             (9, "block", "fused"), (9, "stream", "fused"),
             (9, "overlap", "fused"), (27, "block", "fused"),
             (27, "stream", "fused"), (1, "wave", "fused"),
             (2, "wave", "fused"), (3, "wave", "fused"),
             (9, "wave", "fused"), (27, "wave", "fused")]
#: the --tol mesh runs: (key, --impl)
MESH_TOL_RUNS = [(2, "block"), (9, "block"), (2, "wave")]
#: the ghost-fed wave kernels of the mesh wave arm (the 1D and 2D star):
#: key -> (kernel, the TPU kernel body it replaces)
GHOST_KERNELS = {
    1: ("jacobi1d_wave_ghost", "tpu_comm/kernels/jacobi1d.py:674"),
    2: ("jacobi2d_wave_ghost", "tpu_comm/kernels/jacobi2d.py:621"),
}
#: blocks the ghost-fed kernels take beyond RAGGED: one cell, one row, one
#: column, two rows
GHOST_TINY = {1: [(1,), (2,)], 2: [(1, 1), (1, 300), (300, 1), (2, 257)]}
#: the kernel a mesh wave run launches, once a step: the ghost-fed kernels
#: in 1D and 2D, the 3D wavefront at t = 1, the box waves
MESH_WAVE_KERNELS = {1: "jacobi1d_wave_ghost", 2: "jacobi2d_wave_ghost",
                     3: "jacobi3d_multi", 9: "stencil9_wave",
                     27: "stencil27_wave"}
#: a mesh run's timing loop: warmup and reps of the slope's two lengths
MESH_WARMUP, MESH_REPS = 2, 5
#: loop lengths of a mesh run (the eager face work makes a step long)
MESH_ITERS = 20
#: steps a mesh run's --verify holds against the NumPy golden on the host
#: (one step of the 512^3 27-point golden takes seconds; a multi run
#: rounds it up to its t)
MESH_VERIFY_ITERS = 1
RAGGED = {
    1: [(3,), (1000001,)],
    2: [(3, 3), (37, 301), (1001, 37)],
    3: [(3, 3, 3), (19, 23, 45), (130, 9, 33)],
}
#: the least depth of the 3D kernels that take 2 planes (the 7-point
#: stream needs 3)
LEAST_DEPTH = {"block": (3, 27), "stream": (27,), "wave": (27,)}
#: a non-default chunk per dim (rows / rows / planes), results must not move
ODD_CHUNK = {1: 1, 2: 5, 3: 3}
#: temporal blocking: the family keys with a multi kernel, the kernel and
#: the TPU kernel body it replaces
MULTI_KERNELS = {
    1: ("jacobi1d_multi", "tpu_comm/kernels/jacobi1d.py:426"),
    2: ("jacobi2d_multi", "tpu_comm/kernels/jacobi2d.py:387"),
    9: ("stencil9_multi", "tpu_comm/kernels/stencil9.py:378"),
    3: ("jacobi3d_multi", "tpu_comm/kernels/jacobi3d.py:240"),
}
MULTI_SOURCE = "tpu_comm_torch/csrc/multi.cu"
#: steps a pass of the checks, the single-device runs and the times
MULTI_T = 8
#: the 3D wavefront's instead: JAX's default, and the most JAX fuses at
#: 512^2 planes
MULTI_T_OF = {3: 4}
#: the bcs of each multi family (the 3D wavefront: dirichlet only, as
#: JAX's)
MULTI_BCS = {3: ("dirichlet",)}
#: passes of the full-size check
MULTI_PASSES = 3
#: a non-default tile per field dim (1D: rows of 128; 2D: rows, columns)
MULTI_ODD_TILES = {1: [{"rows_per_chunk": 5}],
                   2: [{"rows_per_chunk": 40, "cols_per_chunk": 72},
                       {"rows_per_chunk": 7, "cols_per_chunk": 300}],
                   3: [{"rows_per_chunk": 8, "cols_per_chunk": 24},
                       {"rows_per_chunk": 5, "cols_per_chunk": 19}]}
#: the t and the tiles phase 5 also times a pass at (float32, dirichlet)
MULTI_T_SWEEP = {1: (1, 2, 4, 16), 2: (1, 2, 4, 16), 3: (1, 2, 8)}
MULTI_TILE_SWEEP = {
    1: [{"rows_per_chunk": r} for r in (8, 16, 64)],
    2: [{"rows_per_chunk": r, "cols_per_chunk": c}
        for r, c in ((48, 48), (32, 96), (96, 96), (48, 112), (64, 112),
                     (256, 112), (512, 112))],
    3: [{"rows_per_chunk": r, "cols_per_chunk": c}
        for r, c in ((12, 56), (24, 28), (24, 56))],
}
#: loop length of the single-device multi runs (a multiple of MULTI_T)
MULTI_ITERS = 96
#: steps per exchange of the mesh multi runs, and the stencil keys they
#: run (each bc)
MESH_MULTI_T = 4
MESH_MULTI_KEYS = (1, 2, 3, 9, 27)
#: the mesh multi runs that skip --verify: the 512^3 ones, whose golden
#: (t steps of the 3D star or the 27-point box on the host) cost a minute
#: of the script's time limit; the arm is plain PyTorch, held against JAX
#: in the CPU tests and verified here in 1D, 2D and 9-point
MESH_MULTI_UNVERIFIED = (3, 27)
#: the sweep runs of phase 4, each at world size 1: (--op, more argv); the
#: default range 1 KiB-64 MiB, and allreduce to 1 GiB (BASELINE.json:8)
SWEEP_RUNS = [(op, []) for op in (
    "allreduce", "allreduce-ring", "rs-ag", "ppermute", "bcast",
    "bcast-tree", "all-to-all")] + [
    ("allreduce-ring", ["--wire-dtype", "bfloat16", "--acc-dtype",
                        "float32"]),
    ("allreduce", ["--max-bytes", str(1 << 30)]),
]
#: the profiled run of phase 4: the 3D block step on a mesh of one, its
#: periodic self-exchange through NCCL; a short timed loop keeps the
#: trace small
PROFILE_ARGV = ["stencil", "--dim", "3", "--size", str(SIZES[3]), "--mesh",
                "1,1,1", "--impl", "block", "--pack", "kernel", "--bc",
                "periodic", "--iters", "20", "--warmup", "1", "--reps", "3",
                "--verify", "--verify-iters", "1"]
#: device ops of the profiled run printed, the most time first
PROFILE_TOP = 10
#: the halo sweeps of phase 4, each ``halo --mesh 1[,1[,1]]`` (float32,
#: periodic, the default 16 KiB-64 MiB a rank): their extra argv
HALO_RUNS = [["--dim", "1"], ["--dim", "2"], ["--dim", "3"],
             ["--dim", "3", "--width", "2"],
             ["--dim", "3", "--halo-wire", "bfloat16"]]
#: the fused runs of phase 4: the profiled 3D block step unfused, then
#: as --fuse-sweep 1,20 (one CUDA graph replay a step, and a chain)
FUSE_ARGV = ["stencil", "--dim", "3", "--size", str(SIZES[3]), "--mesh",
             "1,1,1", "--impl", "block", "--pack", "kernel", "--bc",
             "periodic", "--iters", str(MESH_ITERS), "--warmup",
             str(MESH_WARMUP), "--reps", str(MESH_REPS), "--verify",
             "--verify-iters", str(MESH_VERIFY_ITERS)]
FUSE_SWEEP = (1, MESH_ITERS)
#: the bfloat16-wire runs of phase 4 on a periodic mesh of one: (key,
#: --impl, --pack, more argv)
WIRE_RUNS = [(2, "block", "fused", []), (3, "block", "kernel", []),
             (2, "wave", "fused", []),
             (3, "multi", "fused", ["--t-steps", str(MESH_MULTI_T)])]
#: the partitioned run of phase 4 (2D, periodic, a mesh of one)
PARTS = 4
#: the deep-halo sweep of phase 4
HALOSWEEP_ARGV = ["halosweep", "--dim", "2", "--size", str(SIZES[2]),
                  "--mesh", "1,1", "--bc", "periodic", "--widths",
                  "1,2,4,8", "--iters", "64"]
#: steps of the graph-replay check, and its arms (3D, periodic, a mesh of
#: one): --impl -> --pack
GRAPH_STEPS = 20
GRAPH_ARMS = {"block": "kernel", "stream": "fused"}
#: the overlap runs of phase 4 (3D, periodic, 512^3, a mesh of one):
#: (name, more argv, P2P ops a step, the report's scheduled_overlap:
#: True for the split arms, None for the torch arm, the control, whose
#: reading is reported and not held)
OVERLAP_RUNS = [
    ("overlap", ["--impl", "overlap"], 6, True),
    ("partitioned", ["--impl", "partitioned", "--halo-parts", "4"], 24,
     True),
    ("torch", ["--impl", "torch"], 6, None),
    ("fused", ["--impl", "overlap", "--fuse-steps", str(MESH_ITERS)], 6,
     None),
    ("deep", ["--impl", "overlap", "--fuse-steps", str(MESH_ITERS),
              "--halo-width", "4"], 6, None),
]
#: the pack bench's blocks in phase 4: JAX's default and the main path's
PACK_BENCH_SHAPES = [(128, 128, 512), (SIZES[3],) * 3]
#: phase 4's ``reshard --impl both`` runs on a mesh of one: (the source
#: and destination mesh, --size, --dtype, --iters): the stencils'
#: main-path sizes (256/256/512 MiB a buffer in float32) and JAX's
#: default 2D size in bfloat16, whose 2 MiB round trip (~10 us) needs
#: loops of 200 and 600 for a slope above the host's noise
RESHARD_RUNS = [("1", SIZES[1], "float32", 10),
                ("1,1", SIZES[2], "float32", 10),
                ("1,1,1", SIZES[3], "float32", 10),
                ("1,1", 1024, "bfloat16", 200)]
#: round trips of phase 4's graphed/eager reshard check
RESHARD_GRAPH_TRIPS = 3
#: chained calls of phase 4's graphed/eager attention check
ATTENTION_GRAPH_CALLS = 2
#: phase 4's ``attention`` runs at JAX's defaults (seq 4096, 8 heads,
#: head_dim 128): (--impl, --causal, --dtype)
ATTENTION_RUNS = [("ring", False, "float32"), ("ring", True, "float32"),
                  ("ulysses", False, "float32"), ("ulysses", True, "float32"),
                  ("ring", False, "bfloat16")]
#: iterations a graph of phase 5's eager/graph turns of the 2D reshard
#: round trip and the float32 ring holds
GRAPH_TURN_ITERS = 10
MEMBW_N = 1 << 26
#: 25 rows of 128: the last chunk of 8 rows is ragged
MEMBW_RAGGED = 128 * 8 * 3 + 128
MEMBW_ODD_CHUNK = 3
MEMBW_SOURCE = "tpu_comm_torch/csrc/membw.cu"
#: the scalar of the checks: not representable in any field dtype, so the
#: kernels' narrow-then-widen of s is exercised
MEMBW_S = 0.7
#: kernel -> the TPU body it replaces, the ops it serves, and the op whose
#: time the kernels line carries
MEMBW_KERNELS = {
    "membw_unary": ("tpu_comm/bench/membw.py:89", ("copy", "scale"), "copy"),
    "membw_binary": ("tpu_comm/bench/membw.py:98", ("add", "triad"),
                     "triad"),
    "membw_stream": ("tpu_comm/bench/membw.py:150", ("copy",), "copy"),
    "membw_dma": ("tpu_comm/bench/membw.py:198", ("copy",), "copy"),
}
#: every (op, --impl) pair the JAX CLI accepts, in the port's arm names
MEMBW_RUNS = [(op, arm) for op in ("copy", "scale", "add", "triad")
              for arm in ("torch", "chunked", "both")] + [
    ("copy", "stream"), ("copy", "dma")]
#: the wrapper whose count an arm's run must raise (the torch arm runs no
#: kernel of the port)
MEMBW_WRAPPER = {"chunked": "membw.step_chunked", "both": "membw.step_chunked",
                 "stream": "membw.step_stream", "dma": "membw.step_dma"}
#: the cell widths of the stream copy's instantiations (their mangled
#: template argument: unsigned int, unsigned short)
STREAM_WIDTHS = {"j": "uint32_t", "t": "uint16_t"}
#: every membw_stream instantiation csrc/membw.cu holds: out of place
#: (__restrict__, non-coherent loads) and in place, vector and scalar form,
#: each cell width
STREAM_FORMS = [f"{name}<{w}, {form}>"
                for name in ("membw_stream", "membw_stream_inplace")
                for w in STREAM_WIDTHS.values()
                for form in ("vector", "scalar")]
#: the element types of the chunked kernels' instantiations (their
#: mangled template argument: float, __nv_bfloat16, __half)
CHUNKED_TYPES = {"f": "float", "13__nv_bfloat16": "__nv_bfloat16",
                 "6__half": "__half"}
#: every membw_unary/membw_binary instantiation csrc/membw.cu holds: each
#: op it serves, each element type, vector and scalar form (one form
#: serves in-place and out-of-place calls)
CHUNKED_FORMS = [f"{name}<{t}, {op}, {form}>"
                 for name, ops in (("membw_unary", ("copy", "scale")),
                                   ("membw_binary", ("add", "triad")))
                 for op in ops
                 for t in CHUNKED_TYPES.values()
                 for form in ("vector", "scalar")]
#: rounds of the membw copies timed in turns (a kernel's time is their
#: median)
MEMBW_ROUNDS = 3
#: the stream copy's chunk sweep of phase 5, KiB a CTA (float32)
STREAM_SWEEP_KIB = (4, 16, 32)
#: the chunked copy's, scale's and triad's chunk sweep of phase 5, KiB of
#: each operand a CTA (float32)
CHUNKED_SWEEP_KIB = (4, 8, 16, 32, 64)
#: a fixed row count a CTA that phase 5 times beside the chunked kernels'
#: default in every dtype: the grid their first form took (16 KiB of each
#: operand in float32, 8 KiB in bfloat16)
CHUNKED_FIXED_ROWS = 32
#: op -> the one PyTorch call its chunked kernel is timed beside
MEMBW_CALLS = {
    "copy": "copy_",
    "scale": "torch.mul(x, s, out=dst)",
    "add": "torch.add(x, b, out=dst)",
    "triad": "torch.add(b, x, alpha=s, out=dst)",
}
#: the dma ring's sweep of phase 5: slot KiB x depth (float32; a ring that
#: does not fit a CTA is skipped)
DMA_SWEEP = [(kib, depth) for kib in (8, 16, 32, 64) for depth in (2, 3, 4)]
#: operations per element of each op (its bound's second term)
MEMBW_OPS_PER_ELEM = {"copy": 0, "scale": 1, "add": 1, "triad": 2}
T0 = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps(obj, sort_keys=True), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def random_field(torch, shape, dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.rand(shape, generator=g, device="cuda", dtype=torch.float32)
    return u.to(dtype)


def time_ms(torch, fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` by CUDA events over ``reps``
    back-to-back calls, after a warmup."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(torch, fn, reps: int, filler) -> tuple[float, bool]:
    """Device milliseconds per call of a short ``fn`` whose back-to-back
    calls would be paced by the host: the calls are queued behind
    ``filler()``, device work long enough for the host to enqueue them
    all, so they run on the card without gaps. Returns the time and
    whether the host did finish enqueueing before the filler ended."""
    fn()
    torch.cuda.synchronize()
    fill_end = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    filler()
    fill_end.record()
    start.record()
    for _ in range(reps):
        fn()
    queued = not fill_end.query()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, queued


def l2_fetch_granularity(libs) -> int:
    """The most bytes the card's L2 fetches from DRAM for one missed
    access (``cudaLimitMaxL2FetchGranularity``, read through
    ``csrc/pack.cu``; never set)."""
    import ctypes

    value = ctypes.c_size_t()
    code = libs["pack"].tc_l2_fetch_granularity(ctypes.byref(value))
    if code:
        fail(f"cudaDeviceGetLimit(cudaLimitMaxL2FetchGranularity): {code}")
    return value.value


def check_kernels(torch, mods, arm: str) -> dict:
    """Phase 3: the ``arm`` kernel of each stencil it serves vs the plain
    version, bitwise; returns the max abs error per stencil key (0.0 when
    every case was equal)."""
    from tpu_comm_torch.kernels import run_steps

    errs = {}
    bcs = ARM_BCS.get(arm, ("dirichlet", "periodic"))
    for key in KERNELS[arm]:
        mod, dim = mods[key], DIM[key]
        name = KERNELS[arm][key][0]
        cases = [(SIZES[dim],) * dim] + RAGGED[dim]
        if key in LEAST_DEPTH.get(arm, ()):
            cases = cases + [(2, 3, 3)]
        worst = 0.0
        for shape in cases:
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                for bc in bcs:
                    u = random_field(torch, shape, dtype, seed=dim)
                    got = mod.run(u, CHECK_STEPS, bc=bc, impl=arm)
                    want = run_steps(mod.step_plain, u, CHECK_STEPS, bc)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    worst = max(worst, err)
                    if not torch.equal(got, want) or got.dtype != dtype:
                        fail(f"{name} {shape} {dtype} {bc}: "
                             f"kernel != plain (max abs err {err})")
                    if (arm != "block" and shape == cases[0]
                            and bc == bcs[-1]):
                        knob = ("planes_per_chunk"
                                if dim == 3 and arm != "wave"
                                else "rows_per_chunk")
                        odd = mod.run(u, 2, bc=bc, impl=arm,
                                      **{knob: ODD_CHUNK[dim]})
                        if not torch.equal(odd, mod.run(u, 2, bc=bc,
                                                        impl=arm)):
                            fail(f"{name}: result depends on the chunk")
                    del u, got, want
        if arm == "wave":
            try:
                mod.step_wave(random_field(torch, cases[1], torch.float32,
                                           seed=dim), "periodic")
            except ValueError:
                pass
            else:
                fail(f"{name} took bc=periodic")
        errs[key] = worst
        emit({"check": {"kernel": name, "shapes": cases, "bcs": list(bcs),
                        "steps": CHECK_STEPS, "max_abs_err": worst,
                        "tolerance": "bitwise (torch.equal)",
                        "elapsed_s": time.perf_counter() - T0}})
    return errs


def check_pack(torch) -> float:
    """Phase 3, face pack: the kernel's four faces vs the plain version,
    bitwise, in every dtype, at 512^3 (where the warps stride over the
    items), the ragged shapes, one block for each path of the kernel
    (PACK_PATHS) and blocks whose base lies off the 16-byte grid
    (PACK_OFF_GRID); returns the max abs error (0.0 when every case was
    equal)."""
    from tpu_comm_torch.kernels import pack

    worst = 0.0
    full = (SIZES[3],) * 3
    cases = ([(full, None)] + [(s, None) for s in PACK_RAGGED]
             + [(s, None) for s in PACK_PATHS]
             + [(s, 1) for s in PACK_OFF_GRID])
    for shape, offset in cases:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            if offset is None:
                u = random_field(torch, shape, dtype, seed=40)
            else:
                n = shape[0] * shape[1] * shape[2]
                flat = random_field(torch, (n + offset,), dtype, seed=40)
                u = flat[offset:].view(shape)
                if u.data_ptr() % 16 == 0:
                    fail(f"pack_faces {shape}: the view is on the 16-byte "
                         "grid")
            got, want = pack.pack_faces(u), pack.pack_faces_plain(u)
            torch.cuda.synchronize()
            for name, g, w in zip(pack.FACE_NAMES[2:], got, want):
                err = float((g.float() - w.float()).abs().max())
                worst = max(worst, err)
                if g.dtype != dtype or not torch.equal(g, w):
                    fail(f"pack_faces {shape} {dtype} offset {offset}: "
                         f"{name}: kernel != plain (max abs err {err})")
            del u, got, want
    emit({"check": {"kernel": PACK_KERNEL[0],
                    "shapes": [list(s) for s, _ in cases],
                    "offsets": [o for _, o in cases],
                    "max_abs_err": worst,
                    "tolerance": "bitwise (torch.equal)",
                    "elapsed_s": time.perf_counter() - T0}})
    return worst


def ghost_lines(torch, shape, dtype, seed: int) -> list:
    """Random nonzero ghost lines, in [0.5, 1.5), of a block of ``shape``
    (1D: lo, hi; 2D: up, down, left, right)."""
    if len(shape) == 1:
        shapes = [(1,), (1,)]
    else:
        ny, nx = shape
        shapes = [(1, nx), (1, nx), (ny, 1), (ny, 1)]
    return [(random_field(torch, s, torch.float32, seed + i) + 0.5).to(dtype)
            for i, s in enumerate(shapes)]


def check_ghost_kernels(torch, mods) -> dict:
    """Phase 3, the ghost-fed wave kernels of the mesh wave arm: each
    against its plain version, bitwise, over CHECK_STEPS chained steps with
    fresh ghost lines every step, at full size, RAGGED and GHOST_TINY
    shapes in every dtype; a non-default chunk must not move the result,
    and a bad ghost must be refused. Returns the max abs error per key."""
    errs = {}
    for key, (name, _) in GHOST_KERNELS.items():
        mod, dim = mods[key], DIM[key]
        wrapper = mod.step_wave_ghost
        full = (SIZES[dim],) * dim
        cases = [full] + RAGGED[dim] + GHOST_TINY[dim]
        worst = 0.0
        for shape in cases:
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                u = random_field(torch, shape, dtype, seed=80 + dim)
                got = want = u
                for step in range(CHECK_STEPS):
                    g = ghost_lines(torch, shape, dtype, seed=100 + 4 * step)
                    got = wrapper(got, *g)
                    want = mod.step_wave_ghost_plain(want, *g)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                worst = max(worst, err)
                if not torch.equal(got, want) or got.dtype != dtype:
                    fail(f"{name} {shape} {dtype}: kernel != plain "
                         f"(max abs err {err})")
                if shape == full:
                    odd = wrapper(u, *g, rows_per_chunk=ODD_CHUNK[dim])
                    if not torch.equal(odd, wrapper(u, *g)):
                        fail(f"{name}: result depends on the chunk")
                    del odd
                del u, got, want, g
        u = random_field(torch, RAGGED[dim][-1], torch.float32, seed=dim)
        g = ghost_lines(torch, tuple(u.shape), torch.float32, seed=7)
        before = wrapper.launches
        for bad, why in (
            ([g[0].new_zeros((2,) + tuple(g[0].shape[1:]))] + g[1:],
             "ghost shape"),
            ([g[0].double()] + g[1:], "ghost dtype"),
            ([g[0].cpu()] + g[1:], "ghost device"),
        ):
            try:
                wrapper(u, *bad)
            except ValueError:
                pass
            else:
                fail(f"{name} took a bad {why}")
        try:
            wrapper(u, *g, out=u)
        except ValueError:
            pass
        else:
            fail(f"{name} took an output that aliases its input")
        if wrapper.launches != before:
            fail(f"{name} launched on a refused call")
        errs[key] = worst
        emit({"check": {"kernel": name, "shapes": cases,
                        "steps": CHECK_STEPS, "ghosts": "fresh each step",
                        "max_abs_err": worst,
                        "tolerance": "bitwise (torch.equal)",
                        "elapsed_s": time.perf_counter() - T0}})
    return errs


def _stencil_argv(key: int) -> list:
    """``--dim`` (and ``--points`` for a box stencil) of a stencil key."""
    argv = ["--dim", str(DIM[key])]
    return argv + ["--points", str(key)] if key in BOX else argv


def _workload(key: int) -> str:
    from tpu_comm_torch.kernels import stencil_name

    return f"stencil{DIM[key]}d" + (f"-{stencil_name(key)}" if key in BOX
                                    else "")


#: the NumPy goldens phase 4 keeps (each of a 512^3 field holds 1 GiB of
#: host memory: its input and its result)
GOLDEN_CACHE = 8
#: the stencil driver's --verify steps of the halosweep run: its default 50
#: rounded up to each of --widths 1,2,4,8
HALOSWEEP_VERIFY_ITERS = (50, 52, 56)
#: the goldens of phase 4's mesh runs (the stencil driver's field,
#: float32) computed on the host while the card works, those of the most
#: host time first: (--points or 0, bc, field dim, the steps of each)
GOLDEN_PREFETCH = [
    (0, "periodic", 2, (MESH_VERIFY_ITERS, *HALOSWEEP_VERIFY_ITERS)),
    (0, "periodic", 3, (MESH_VERIFY_ITERS, MESH_MULTI_T, MESH_ITERS)),
    (0, "dirichlet", 3, (MESH_VERIFY_ITERS,)),
    (27, "periodic", 3, (MESH_VERIFY_ITERS,)),
    (27, "dirichlet", 3, (MESH_VERIFY_ITERS,)),
]


def share_goldens() -> None:
    """One NumPy golden per (stencil, input field, bc, iterations): phase 4
    holds many arms of a stencil against the same golden (one step of the
    512^3 27-point golden takes seconds on the host), so the driver's
    golden runs (``reference.GOLDEN_RUNS``) are wrapped to keep the last
    GOLDEN_CACHE results and hand one back where the input field is equal
    (``np.array_equal``) and the rest of the key the same; a golden of
    more steps than one kept goes on from the kept one. The goldens of
    GOLDEN_PREFETCH are computed meanwhile, one host thread a chain
    (NumPy leaves the GIL for its array loops), while the card runs
    phases 3 and 4; a run that needs one waits for it. The stencil driver's
    check itself is unchanged."""
    import threading
    from concurrent.futures import Future

    import numpy as np

    from tpu_comm_torch.kernels import reference

    kept = []  # (points, iters, bc, input, golden), the newest last
    chains = []  # (points, bc, input, {iters: Future})

    def run_chain(run, u, bc, futures):
        done = 0
        for n, fut in futures.items():
            try:
                u = run(u, n - done, bc=bc)
            except BaseException as e:  # every later step fails with it
                for later in list(futures.values())[
                        list(futures).index(n):]:
                    later.set_exception(e)
                return
            done = n
            fut.set_result(u)

    for points, bc, dim, steps in GOLDEN_PREFETCH:
        u0 = reference.init_field((SIZES[dim],) * dim, dtype=np.float32)
        futures = {n: Future() for n in sorted(steps)}
        chains.append((points, bc, u0, futures))
        threading.Thread(
            target=run_chain, daemon=True,
            args=(reference.GOLDEN_RUNS[points], u0, bc, futures),
        ).start()

    for points, run in list(reference.GOLDEN_RUNS.items()):
        def shared(u0, iters, bc="dirichlet", _run=run, _points=points):
            for p, b, u, futures in chains:
                if ((p, b) == (_points, bc) and iters in futures
                        and u.shape == u0.shape and u.dtype == u0.dtype
                        and np.array_equal(u, u0)):
                    return futures[iters].result()
            # the most steps kept of this (stencil, bc, input) up to
            # iters: the golden steps on from there (a golden is a loop
            # of steps, so that is the same field)
            best, start = None, None
            for i, (p, it, b, u, want) in enumerate(kept):
                if ((p, b) == (_points, bc) and it <= iters
                        and (best is None or it > kept[best][1])
                        and u.shape == u0.shape and u.dtype == u0.dtype
                        and np.array_equal(u, u0)):
                    best, start = i, want
            if best is not None and kept[best][1] == iters:
                kept.append(kept.pop(best))
                return start
            want = (_run(u0, iters, bc=bc) if best is None
                    else _run(start, iters - kept[best][1], bc=bc))
            kept.append((_points, iters, bc, u0.copy(), want))
            del kept[:-GOLDEN_CACHE]
            return want

        reference.GOLDEN_RUNS[points] = shared


def drive_main_path(torch, counters) -> dict:
    """Phase 4: the single-device driver at full size per (stencil,
    arm) of MAIN_RUNS; returns each kernel's launches summed over the
    runs."""
    from tpu_comm_torch import cli

    launches = {name: 0 for name in counters}
    with tempfile.TemporaryDirectory() as tmp:
        for key, impl in MAIN_RUNS:
            path = Path(tmp) / f"stencil{key}-{impl}.jsonl"
            for w in counters.values():
                w.launches = 0
            argv = ["stencil", *_stencil_argv(key), "--size",
                    str(SIZES[DIM[key]]), "--impl", impl, "--verify",
                    "--verify-iters", str(VERIFY_ITERS), "--jsonl",
                    str(path)]
            rc = cli.main(argv)
            counts = {k: w.launches for k, w in counters.items()}
            what = " ".join(argv[1:-2])
            arm = "stream" if impl == "auto" else impl
            # the torch arm runs plain PyTorch: no kernel of the port
            name = KERNELS[arm][key][0] if arm in KERNELS else None
            if rc != 0:
                fail(f"{what} exited {rc}")
            row = json.loads(path.read_text().splitlines()[-1])
            want = {"platform": "cuda", "verified": True, "impl": arm,
                    "workload": _workload(key)}
            got = {k: row.get(k) for k in want}
            if got != want:
                fail(f"{what}: row says {got}, expected {want}")
            if name is not None and counts[name] == 0:
                fail(f"{name} was not launched on the main path")
            if any(c for k, c in counts.items() if k != name):
                fail(f"{what} launched other kernels: {counts}")
            if name is not None:
                launches[name] += counts[name]
            emit({"main_path": {"stencil": _workload(key), "impl": arm,
                                "kernel": name,
                                "launches": counts.get(name, 0),
                                "gbps_eff": row["gbps_eff"],
                                "secs_per_iter": row["secs_per_iter"],
                                "elapsed_s": time.perf_counter() - T0}})
    return launches


def drive_mesh(torch, counters, tol_iters: dict) -> dict:
    """Phase 4, the distributed stencil at world size 1: ``stencil --mesh
    1[,1[,1]]`` per (stencil, arm, pack) of MESH_RUNS and bc, and the
    ``--tol`` runs (their rounds kept in ``tol_iters`` by (key, --impl));
    every row ran as CUDA graph replays. Returns each kernel's launches
    summed over the runs."""
    from tpu_comm_torch import cli

    launches = {name: 0 for name in counters}
    runs = [(key, impl, pack, bc, []) for key, impl, pack in MESH_RUNS
            for bc in ("dirichlet", "periodic")]
    runs += [(key, impl, "fused", "dirichlet",
              ["--tol", "1e-3", "--check-every", "4"])
             for key, impl in MESH_TOL_RUNS]
    runs += [(key, "multi", "fused", bc, ["--t-steps", str(MESH_MULTI_T)])
             for key in MESH_MULTI_KEYS for bc in ("dirichlet", "periodic")]
    with tempfile.TemporaryDirectory() as tmp:
        for n, (key, impl, pack, bc, extra) in enumerate(runs):
            dim = DIM[key]
            tol = "--tol" in extra
            verify = not (impl == "multi" and key in MESH_MULTI_UNVERIFIED)
            path = Path(tmp) / f"mesh{n}.jsonl"
            for w in counters.values():
                w.launches = 0
            argv = ["stencil", "--mesh", ",".join(["1"] * dim),
                    *_stencil_argv(key), "--size",
                    str(SIZES[dim]),
                    "--impl", impl, "--pack", pack, "--bc", bc,
                    *(["--verify"] if verify else []),
                    "--verify-iters", str(MESH_VERIFY_ITERS), "--iters",
                    str(8 if tol else MESH_ITERS), "--warmup",
                    str(MESH_WARMUP), "--reps", str(MESH_REPS), "--jsonl",
                    str(path), *extra]
            rc = cli.main(argv)
            counts = {k: w.launches for k, w in counters.items()}
            what = " ".join(argv[1:-2] + extra)
            if rc != 0:
                fail(f"{what} exited {rc}")
            row = json.loads(path.read_text().splitlines()[-1])
            arm = "overlap" if impl == "auto" else impl
            want = {"platform": "cuda", "verified": verify, "impl": arm,
                    "pack": pack, "mesh": [1] * dim, "topo_plan": None,
                    "workload": f"{_workload(key)}-dist"
                    + ("-conv" if tol else ""), "dispatch": "graph",
                    # a graph a round, or one a loop of the slope
                    "graph_steps": [4] if tol else [MESH_ITERS,
                                                    3 * MESH_ITERS]}
            if arm == "multi":
                want["t_steps"] = MESH_MULTI_T
            got = {k: row.get(k) for k in want}
            if got != want:
                fail(f"{what}: row says {got}, expected {want}")
            expected = set()
            if arm == "wave":
                expected.add(MESH_WAVE_KERNELS[key])
            elif arm in KERNELS:
                expected.add(KERNELS[arm][key][0])
            if pack == "kernel":
                expected.add(PACK_KERNEL[0])
            launched = {k for k, c in counts.items() if c}
            if launched != expected:
                fail(f"{what} launched {sorted(launched)}, expected "
                     f"{sorted(expected)}: {counts}")
            # the verify run's steps, then iters and 3 * iters a timed loop
            steps = MESH_VERIFY_ITERS + (
                (MESH_WARMUP + MESH_REPS) * 4 * MESH_ITERS)
            if arm == "wave" and not tol and counts[
                    MESH_WAVE_KERNELS[key]] != steps:
                fail(f"{what}: {MESH_WAVE_KERNELS[key]} launched "
                     f"{counts[MESH_WAVE_KERNELS[key]]} times, expected "
                     f"{steps} (one a step)")
            for k in expected:
                launches[k] += counts[k]
            if tol:
                tol_iters[key, impl] = row["iters"]
            emit({"main_path": {
                "mesh": [1] * dim, "stencil": _workload(key), "impl": arm,
                "pack": pack, "bc": bc, "dispatch": row["dispatch"],
                "tol": tol, **({"t_steps": MESH_MULTI_T}
                               if arm == "multi" else {}),
                "launches": {k: counts[k] for k in sorted(expected)},
                "gbps_eff": row["gbps_eff"], "iters": row["iters"],
                "secs_per_iter": row["secs_per_iter"],
                "elapsed_s": time.perf_counter() - T0}})
    return launches


def drive_sweep(torch, counters) -> None:
    """Phase 4, the collective sweep at world size 1: ``sweep --op OP
    --n-devices 1`` per SWEEP_RUNS, through NCCL; no kernel of the port
    may launch."""
    from tpu_comm_torch import cli
    from tpu_comm_torch.bench import SWEEP_OPS
    from tpu_comm_torch.bench.sweep import SweepConfig

    if sorted({op for op, _ in SWEEP_RUNS}) != sorted(SWEEP_OPS):
        fail(f"phase 4 sweeps {SWEEP_RUNS}, the port has {SWEEP_OPS}")
    with tempfile.TemporaryDirectory() as tmp:
        for n, (op, extra) in enumerate(SWEEP_RUNS):
            path = Path(tmp) / f"sweep{n}.jsonl"
            for w in counters.values():
                w.launches = 0
            argv = ["sweep", "--op", op, "--n-devices", "1", "--jsonl",
                    str(path), *extra]
            rc = cli.main(argv)
            counts = {k: w.launches for k, w in counters.items()}
            what = " ".join(argv[1:5] + extra)
            if rc != 0:
                fail(f"{what} exited {rc}")
            rows = [json.loads(line)
                    for line in path.read_text().splitlines()]
            max_bytes = int(extra[1]) if "--max-bytes" in extra else None
            sizes = SweepConfig(**({"max_bytes": max_bytes} if max_bytes
                                   else {})).sizes()
            if [r["size"] for r in rows] != sizes:
                fail(f"{what}: rows of sizes {[r['size'] for r in rows]}, "
                     f"expected {sizes}")
            want = {"platform": "cuda", "verified": True, "mesh": [1],
                    "gbps_bus": 0.0, "workload": f"sweep-{op}"}
            for r in rows:
                # bcast-tree does nothing at one rank (JAX returns x): its
                # slope is Python noise and may fall below the clock's
                # resolution, where the row reports null rates, as JAX's;
                # every other op's row must resolve (the sweep times a lost
                # slope again with longer loops)
                unresolved = op == "bcast-tree" and \
                    r["below_timing_resolution"]
                got = {k: r.get(k) for k in want}
                if got != {**want, **({"gbps_bus": None} if unresolved
                                      else {})}:
                    fail(f"{what}: a row says {got}, expected {want}")
            if any(counts.values()):
                fail(f"{what} launched kernels of the port: {counts}")
            emit({"main_path": {
                "sweep": {"op": op, "argv": extra, "mesh": [1]},
                "launches": 0,
                "below_timing_resolution": sum(
                    r["below_timing_resolution"] for r in rows),
                # rows timed again with a longer loop (a lost slope)
                "retimed": sum(r["iters"] != SweepConfig.iters
                               for r in rows),
                "gbps_alg": {r["size"]: r["gbps_alg"] for r in rows},
                "secs_per_iter": {r["size"]: r["secs_per_iter"]
                                  for r in rows},
                "elapsed_s": time.perf_counter() - T0}})


def drive_profile(torch, counters) -> None:
    """Phase 4, ``stencil --profile``: PROFILE_ARGV with and without the
    trace. The trace must be this rank's file alone and hold the block
    kernel and an NCCL kernel; prints its PROFILE_TOP device and host ops
    (a host op's time includes what it encloses), and the device's busy
    time a step beside the step time of each run."""
    from tpu_comm_torch import cli
    from tpu_comm_torch.bench.trace import trace_ops

    block = KERNELS["block"][3][0]
    seconds, rows = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        prof = Path(tmp) / "prof"
        for traced in (False, True):
            path = Path(tmp) / f"profile{int(traced)}.jsonl"
            for w in counters.values():
                w.launches = 0
            argv = PROFILE_ARGV + ["--jsonl", str(path)] + (
                ["--profile", str(prof)] if traced else [])
            t0 = time.perf_counter()
            rc = cli.main(argv)
            seconds[traced] = time.perf_counter() - t0
            counts = {k: w.launches for k, w in counters.items()}
            what = " ".join(argv[1:])
            if rc != 0:
                fail(f"{what} exited {rc}")
            row = rows[traced] = json.loads(
                path.read_text().splitlines()[-1])
            want = {"platform": "cuda", "verified": True, "impl": "block",
                    "pack": "kernel", "mesh": [1, 1, 1]}
            got = {k: row.get(k) for k in want}
            if got != want:
                fail(f"{what}: row says {got}, expected {want}")
            launched = {k for k, c in counts.items() if c}
            if launched != {block, PACK_KERNEL[0]}:
                fail(f"{what} launched {sorted(launched)}: {counts}")
        files = sorted(p.name for p in prof.iterdir())
        if files != ["rank0.json"]:
            fail(f"--profile wrote {files}, expected ['rank0.json']")
        trace = prof / "rank0.json"
        t0 = time.perf_counter()
        ops = trace_ops(trace)
        parse_s = time.perf_counter() - t0
        host = trace_ops(trace, ("cpu_op", "cuda_runtime"))
        if not any(block in name for name in ops):
            fail(f"the trace holds no {block} kernel: {sorted(ops)[:20]}")
        if not any("nccl" in name.lower() for name in ops):
            fail(f"the trace holds no NCCL kernel: {sorted(ops)[:20]}")
        busy_us = sum(t for _, t in ops.values())
        # the traced region: the slope's two loops, warmup and reps, one
        # block kernel a step
        region_s = sum(row["phases"].values())
        steps = sum(c for name, (c, _) in ops.items() if block in name)

        def top(table):
            return [{"name": name, "count": c, "total_ms": t / 1e3,
                     "mean_us": t / c}
                    for name, (c, t) in sorted(
                        table.items(), key=lambda kv: -kv[1][1]
                    )[:PROFILE_TOP]]

        emit({"profile": {
            "argv": PROFILE_ARGV, "trace_bytes": trace.stat().st_size,
            "run_s": seconds[False], "profiled_run_s": seconds[True],
            "secs_per_iter": {"plain": rows[False]["secs_per_iter"],
                              "profiled": rows[True]["secs_per_iter"]},
            "parse_s": parse_s, "device_ops": len(ops),
            "device_busy_ms": busy_us / 1e3, "steps": steps,
            "device_busy_ms_a_step": busy_us / 1e3 / steps,
            "traced_region_s": region_s,
            "device_busy_share": busy_us / 1e6 / region_s,
            "launches": {k: c for k, c in counts.items() if c},
            "top_device_ops": top(ops),
            "top_host_ops": top(host),
            "elapsed_s": time.perf_counter() - T0}})


def _quiet_main(argv) -> tuple[int, str]:
    """``cli.main(argv)`` with its standard output kept, not printed."""
    import contextlib
    import io

    from tpu_comm_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def _run_counted(counters, argv) -> tuple[list, dict]:
    """Phase 4's frame around one run: every count set to 0 just before,
    read just after; the run must exit 0. Returns its printed rows and
    the counts."""
    for w in counters.values():
        w.launches = 0
    rc, out = _quiet_main(argv)
    counts = {k: w.launches for k, w in counters.items()}
    if rc != 0:
        fail(f"{' '.join(argv)} exited {rc}")
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")], counts


def _want_row(what: str, row: dict, want: dict) -> None:
    got = {k: row.get(k) for k in want}
    if got != want:
        fail(f"{what}: row says {got}, expected {want}")


def _want_launched(what: str, counts: dict, expected: set) -> None:
    launched = {k for k, c in counts.items() if c}
    if launched != expected:
        fail(f"{what} launched {sorted(launched)}, expected "
             f"{sorted(expected)}: {counts}")


def drive_halo(torch, counters) -> dict:
    """Phase 4, the halo microbench and the shaping axes at world size 1:
    the ``halo`` sweeps of HALO_RUNS (no kernel; 0.0 GB/s, the cost of the
    self-exchange a step), the 3D block step unfused and as
    ``--fuse-sweep 1,20`` (CUDA graph replays; launches counted through
    the replays, held to the eager run's launches a step), the
    partitioned exchange, the bfloat16 wire of WIRE_RUNS and
    ``halosweep``; every row verified on ``cuda``. Returns each kernel's
    launches summed over the runs."""
    launches = {name: 0 for name in counters}
    for extra in HALO_RUNS:
        dim = int(extra[1])
        argv = ["halo", "--mesh", ",".join(["1"] * dim), *extra]
        rows, counts = _run_counted(counters, argv)
        what = " ".join(argv)
        if any(counts.values()):
            fail(f"{what} launched kernels of the port: {counts}")
        for row in rows:
            _want_row(what, row, {
                "platform": "cuda", "verified": True, "mesh": [1] * dim,
                "workload": f"halo{dim}d", "halo_gbps_per_chip": 0.0,
                "halo_bytes_per_chip_per_iter": 0})
        emit({"main_path": {
            "halo": extra, "mesh": [1] * dim, "launches": 0,
            "secs_per_iter": {r["size"]: r["secs_per_iter"] for r in rows},
            "local_size": {r["size"]: r["local_size"] for r in rows},
            "elapsed_s": time.perf_counter() - T0}})

    # the fused step: per-step launches from the unfused run, then each
    # fused row held to them over its own steps (verify + the slope's)
    block, pack = KERNELS["block"][3][0], PACK_KERNEL[0]
    secs, per_step = {}, None
    for fuse in (None, *FUSE_SWEEP):
        argv = FUSE_ARGV + ([] if fuse is None else
                            ["--fuse-steps", str(fuse)])
        (row,), counts = _run_counted(counters, argv)
        what = " ".join(argv[1:])
        _want_row(what, row, {"platform": "cuda", "verified": True,
                              "impl": "block", "pack": "kernel",
                              "fuse_steps": fuse})
        _want_launched(what, counts, {block, pack})
        verify = MESH_VERIFY_ITERS if fuse is None else max(
            fuse, MESH_VERIFY_ITERS)
        steps = verify + (MESH_WARMUP + MESH_REPS) * 4 * MESH_ITERS
        if per_step is None:
            per_step = {k: counts[k] / steps for k in (block, pack)}
        want = {k: per_step[k] * steps for k in (block, pack)}
        if {k: counts[k] for k in want} != want:
            fail(f"{what}: launches {counts}, expected {want} "
                 f"({per_step} a step over {steps} steps)")
        for k in want:
            launches[k] += counts[k]
        # unfused: the run's own graphs (20- and 60-step chains)
        secs["unfused" if fuse is None else f"fuse{fuse}"] = \
            row["secs_per_iter"]
    emit({"fused_step": {"argv": FUSE_ARGV[1:], "secs_per_iter": secs,
                         "launches_a_step": per_step,
                         "elapsed_s": time.perf_counter() - T0}})

    argv = ["stencil", "--dim", "2", "--size", str(SIZES[2]), "--mesh",
            "1,1", "--bc", "periodic", "--impl", "partitioned",
            "--halo-parts", str(PARTS), "--iters", str(MESH_ITERS),
            "--warmup", str(MESH_WARMUP), "--reps", str(MESH_REPS),
            "--verify", "--verify-iters", str(MESH_VERIFY_ITERS)]
    (row,), counts = _run_counted(counters, argv)
    _want_row(" ".join(argv), row, {
        "platform": "cuda", "verified": True, "impl": "partitioned",
        "halo_parts": PARTS, "mesh": [1, 1]})
    _want_launched(" ".join(argv), counts, set())
    emit({"main_path": {"mesh": [1, 1], "impl": "partitioned",
                        "halo_parts": PARTS, "launches": 0,
                        "secs_per_iter": row["secs_per_iter"],
                        "elapsed_s": time.perf_counter() - T0}})

    for key, impl, pack_impl, extra in WIRE_RUNS:
        dim = DIM[key]
        argv = ["stencil", "--dim", str(dim), "--size", str(SIZES[dim]),
                "--mesh", ",".join(["1"] * dim), "--bc", "periodic",
                "--impl", impl, "--pack", pack_impl, "--halo-wire",
                "bfloat16", "--iters", str(MESH_ITERS), "--warmup",
                str(MESH_WARMUP), "--reps", str(MESH_REPS), "--verify",
                "--verify-iters", str(MESH_VERIFY_ITERS), *extra]
        (row,), counts = _run_counted(counters, argv)
        what = " ".join(argv[1:])
        _want_row(what, row, {"platform": "cuda", "verified": True,
                              "impl": impl, "wire_dtype": "bfloat16",
                              "pack": pack_impl})
        expected = set()
        if impl == "wave":
            expected.add(MESH_WAVE_KERNELS[key])
        elif impl in KERNELS:
            expected.add(KERNELS[impl][key][0])
        if pack_impl == "kernel":
            expected.add(PACK_KERNEL[0])
        _want_launched(what, counts, expected)
        for k in expected:
            launches[k] += counts[k]
        emit({"main_path": {
            "mesh": [1] * dim, "stencil": _workload(key), "impl": impl,
            "pack": pack_impl, "bc": "periodic", "wire_dtype": "bfloat16",
            "launches": {k: counts[k] for k in sorted(expected)},
            "secs_per_iter": row["secs_per_iter"],
            "halo_bytes_per_chip_per_iter":
                row["halo_bytes_per_chip_per_iter"],
            "elapsed_s": time.perf_counter() - T0}})

    lines, counts = _run_counted(counters, HALOSWEEP_ARGV)
    rows, summary = lines[:-1], lines[-1]
    _want_launched(" ".join(HALOSWEEP_ARGV), counts, set())
    for row in rows:
        _want_row("halosweep", row, {"platform": "cuda", "verified": True,
                                     "impl": "overlap", "mesh": [1, 1]})
    if summary.get("mode") != "halosweep" or not summary["verified"]:
        fail(f"halosweep: summary {summary}")
    emit({"halosweep": {**summary, "elapsed_s": time.perf_counter() - T0}})
    return launches


def _wrapper_name(w) -> str:
    return f"{w.__module__.rsplit('.', 1)[-1]}.{w.__name__}"


def _named(counts: dict) -> dict:
    """Wrapper -> launches as wrapper name -> launches."""
    return {_wrapper_name(w): n for w, n in counts.items()}


def check_graph_replay(torch) -> dict:
    """Phase 4's card check of the graph runner: a chain of GRAPH_STEPS
    steps of each arm of GRAPH_ARMS (3D, periodic, float32, a mesh of one
    through NCCL, full size) run eagerly, then replayed from its CUDA
    graph (the second call of a cached chain replays and nothing else):
    bitwise equal. The launches a replay adds are what the capture
    recorded, and equal the eager chain's."""
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.domain import Decomposition
    from tpu_comm_torch.kernels import distributed as pdist
    from tpu_comm_torch.kernels import launch_wrappers
    from tpu_comm_torch.topo import make_cart_mesh

    result = {}
    with launch.process_group("nccl"):
        dec = Decomposition(make_cart_mesh(3, periodic=True),
                            (SIZES[3],) * 3)
        u = random_field(torch, dec.local_shape, torch.float32, 15)
        wrappers = launch_wrappers()
        for impl, pack_impl in GRAPH_ARMS.items():
            before = [w.launches for w in wrappers]
            want = pdist._run_distributed_eager(
                u, dec, GRAPH_STEPS, bc="periodic", impl=impl,
                pack=pack_impl)
            eager = {_wrapper_name(w): w.launches - b
                     for w, b in zip(wrappers, before) if w.launches != b}
            graphs = {}
            pdist.run_distributed_fused(u, dec, GRAPH_STEPS, GRAPH_STEPS,
                                        bc="periodic", impl=impl,
                                        pack=pack_impl, graphs=graphs)
            before = [w.launches for w in wrappers]
            got, _ = pdist.run_distributed_fused(
                u, dec, GRAPH_STEPS, GRAPH_STEPS, bc="periodic", impl=impl,
                pack=pack_impl, graphs=graphs)
            torch.cuda.synchronize()
            replayed = {_wrapper_name(w): w.launches - b
                        for w, b in zip(wrappers, before) if w.launches != b}
            (chain,) = [g for g in graphs.values()
                        if isinstance(g, pdist.GraphChain)]
            captured = {_wrapper_name(w): n
                        for w, n in chain.captured.items()}
            pdist.release_graphs(graphs)
            if chain.replays != 1:
                fail(f"graph check {impl}: {chain.replays} replays, not 1")
            if not torch.equal(got, want):
                fail(f"graph check {impl}: the replayed chain differs from "
                     f"the eager one by {(got - want).abs().max().item()}")
            if not replayed == captured == eager:
                fail(f"graph check {impl}: launches of the replay "
                     f"{replayed}, captured {captured}, eager {eager}")
            result[impl] = {"steps": GRAPH_STEPS, "pack": pack_impl,
                            "launches_a_replay": captured,
                            "tolerance": "bitwise (torch.equal)"}
    emit({"check": {"graph_replay": result,
                    "elapsed_s": time.perf_counter() - T0}})
    return result


def check_graph_convergence(torch, tol_iters: dict) -> dict:
    """Phase 4's card check of the convergence loop: each ``--tol`` run of
    MESH_TOL_RUNS at its full size on a mesh of one (the driver's field),
    a CUDA graph a round with the residual's ``all_reduce`` inside, held
    to the eager loop: the same rounds (``iters_run``, also the CLI
    row's), the same residual, the same field bitwise."""
    import numpy as np

    from tpu_comm_torch.bench import stencil as pstencil
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.domain import Decomposition
    from tpu_comm_torch.kernels import distributed as pdist
    from tpu_comm_torch.kernels import stencil_name
    from tpu_comm_torch.topo import make_cart_mesh

    result = {}
    with launch.process_group("nccl"):
        for key, impl in MESH_TOL_RUNS:
            dim = DIM[key]
            cfg = pstencil.StencilConfig(
                dim=dim, points=key if key in BOX else 0, size=SIZES[dim],
                iters=8, tol=1e-3, check_every=4, impl=impl,
                mesh=(1,) * dim)
            dec = Decomposition(make_cart_mesh(dim), cfg.global_shape)
            u = dec.scatter(pstencil._initial_field(cfg, np.float32),
                            "cuda", torch.float32)
            kw = {"stencil": stencil_name(cfg.points)}
            graphs = {}
            try:
                got = pdist.run_distributed_to_convergence(
                    u, dec, cfg.tol, cfg.iters, check_every=cfg.check_every,
                    impl=impl, graphs=graphs, **kw)
            finally:
                pdist.release_graphs(graphs)
            want = pdist._convergence_eager(
                u, dec, cfg.tol, cfg.iters, check_every=cfg.check_every,
                impl=impl, **kw)
            what = f"graph convergence {_workload(key)} {impl}"
            if got[1:] != want[1:] or got[1] != tol_iters[key, impl]:
                fail(f"{what}: graphed (iters, residual) {got[1:]}, eager "
                     f"{want[1:]}, the CLI row's iters "
                     f"{tol_iters[key, impl]}")
            if not torch.equal(got[0], want[0]):
                fail(f"{what}: the field differs from the eager loop's by "
                     f"{(got[0] - want[0]).abs().max().item()}")
            result[f"{_workload(key)} {impl}"] = {
                "iters_run": got[1], "residual": got[2],
                "tolerance": "bitwise (torch.equal)"}
            del u, got, want
    emit({"check": {"graph_convergence": result,
                    "elapsed_s": time.perf_counter() - T0}})
    return result


def drive_overlap(torch, counters) -> dict:
    """Phase 4, the ``overlap`` subcommand on the card at world size 1
    (periodic 512^3: every face goes to the own rank through NCCL): the
    reports of ``--impl overlap`` and ``partitioned``, which must read
    compute in flight beside an NCCL kernel (``scheduled_overlap``), and
    of ``torch``, the control, whose reading is reported; and the fused
    audits, which must read one graph launch a dispatch, no host call
    during it, and a graph of ``MESH_ITERS / trip`` trips' NCCL nodes
    (``exchange_in_graph``; with ``--halo-width`` one width-1 window's a
    window). Launches no kernel of the port. Returns the documents."""
    docs = {}
    base = ["overlap", "--dim", "3", "--size", str(SIZES[3]), "--bc",
            "periodic"]
    for name, extra, sends, overlap in OVERLAP_RUNS:
        argv = base + extra
        (doc,), counts = _run_counted(counters, argv)
        what = " ".join(argv)
        emit({"overlap": {"argv": extra, **doc,
                          "elapsed_s": time.perf_counter() - T0}})
        _want_launched(what, counts, set())
        if doc["platform"] != "cuda" or doc["n_permutes"] != sends:
            fail(f"{what}: {doc}, expected {sends} P2P ops a step")
        if "--fuse-steps" in extra:
            want = {"n_executables": 1, "exchange_in_graph": True,
                    "host_roundtrips_between_steps": 0}
            if "--halo-width" in extra:
                want["one_exchange_per_window"] = True
            _want_row(what, doc, want)
        elif doc["n_async_pairs"] < 1 or not isinstance(
                doc["scheduled_overlap"], bool) or (
                overlap is not None and doc["scheduled_overlap"] is not
                overlap):
            fail(f"{what}: {doc}, expected NCCL kernels and "
                 f"scheduled_overlap {overlap if overlap else 'a bool'}")
        docs[name] = doc
    return docs


def drive_pack_bench(torch, counters) -> dict:
    """Phase 4, the ``pack`` subcommand on the card, both arms, at JAX's
    default block and at the main path's 512^3: verified rows timed as
    graph replays; the kernel arm launches the face-pack kernel once a
    pack (the verify pack, then (warmup + reps) x (iters + 3 iters)), the
    fused arm none. Returns the face-pack kernel's launches."""
    launches = 0
    for shape in PACK_BENCH_SHAPES:
        argv = ["pack", "--nz", str(shape[0]), "--ny", str(shape[1]),
                "--nx", str(shape[2]), "--impl", "both"]
        rows, counts = _run_counted(counters, argv)
        what = " ".join(argv)
        for row, arm in zip(rows, ("fused", "kernel")):
            _want_row(what, row, {"platform": "cuda", "verified": True,
                                  "dispatch": "graph", "impl": arm,
                                  "size": list(shape)})
        want = 1 + (2 + 5) * 4 * 20  # the CLI's defaults
        if counts[PACK_KERNEL[0]] != want or len(rows) != 2:
            fail(f"{what}: {len(rows)} rows, {counts[PACK_KERNEL[0]]} "
                 f"pack launches, expected 2 and {want}")
        _want_launched(what, counts, {PACK_KERNEL[0]})
        launches += counts[PACK_KERNEL[0]]
        emit({"pack_bench": {
            "size": list(shape),
            **{r["impl"]: {k: r[k] for k in ("secs_per_iter", "gbps_faces",
                                              "gbps_eff", "bytes_per_iter")}
               for r in rows},
            "elapsed_s": time.perf_counter() - T0}})
    return {PACK_KERNEL[0]: launches}


def drive_reshard(torch, counters) -> None:
    """Phase 4, ``reshard --impl both`` on a mesh of one per RESHARD_RUNS
    (the NCCL group of one: the naive arm's all-gather and the sequential
    arm's local copy): both rows verified (bitwise against the oracle),
    timed as graph replays, no kernel of the port launched; each row's
    measured peak live bytes printed beside the model's."""
    for mesh, size, dtype, iters in RESHARD_RUNS:
        argv = ["reshard", "--src-mesh", mesh, "--dst-mesh", mesh,
                "--size", str(size), "--dtype", dtype, "--impl", "both",
                "--iters", str(iters)]
        rows, counts = _run_counted(counters, argv)
        what = " ".join(argv)
        if [r.get("impl") for r in rows] != ["naive", "sequential"]:
            fail(f"{what}: rows {[r.get('impl') for r in rows]}")
        for r in rows:
            _want_row(what, r, {
                "platform": "cuda", "verified": True, "dispatch": "graph",
                "workload": "reshard", "dtype": dtype, "moved_bytes": 0,
                "size": [size] * len(mesh.split(",")),
                # the bench times a lost slope again with longer loops; a
                # row still unresolved has no time to print
                "below_timing_resolution": False})
            if not isinstance(r.get("peak_live_bytes_measured"), int):
                fail(f"{what}: no measured peak live bytes in {r}")
            emit({"reshard": {
                "impl": r["impl"], "mesh": r["src_mesh"], "size": r["size"],
                "dtype": dtype,
                "peak_live_bytes": r["peak_live_bytes"],
                "peak_live_bytes_measured": r["peak_live_bytes_measured"],
                **{k: r[k] for k in ("secs_per_reshard", "reshard_steps",
                                     "graph_steps", "iters")},
                # rows timed again with a longer loop (a lost slope)
                "retimed": r["iters"] != iters,
                "elapsed_s": time.perf_counter() - T0}})
        _want_launched(what, counts, set())


def check_reshard_graph(torch) -> None:
    """Phase 4, each reshard arm at each RESHARD_RUNS configuration:
    RESHARD_GRAPH_TRIPS round trips replayed from a CUDA graph
    (``GraphLoop``, as the bench's timed loop runs them) bitwise equal to
    the same round trips launched eagerly, and to the block (a mesh of
    one moves nothing)."""
    from tpu_comm_torch.bench.reshard import _host_field
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.comm import reshard as rs
    from tpu_comm_torch.kernels.graphs import GraphLoop
    from tpu_comm_torch.kernels.tiling import DTYPES as TORCH_DTYPES

    n = RESHARD_GRAPH_TRIPS
    with launch.process_group("nccl"):
        for mesh, size, dtype, _ in RESHARD_RUNS:
            m = tuple(int(a) for a in mesh.split(","))
            gshape = (size,) * len(m)
            dt = TORCH_DTYPES[dtype]
            plan = rs.plan_reshard(gshape, m, m, dt.itemsize)
            x = _host_field(gshape, dt).cuda()
            for arm in rs.ARMS:
                def trip(u, arm=arm):
                    return rs.reshard_block(
                        rs.reshard_block(u, plan, arm), plan, arm)

                eager = x
                for _ in range(n):
                    eager = trip(eager)
                loop = GraphLoop(trip, x)
                try:
                    loop.run(n)  # eager on a side stream, then the capture
                    same = torch.equal(loop.run(n), eager)  # a replay
                    replays = loop.graphs[n].replays
                finally:
                    loop.release()
                what = f"graphed reshard {arm} {mesh} {size} {dtype}"
                if replays != 1 or not same or not torch.equal(eager, x):
                    fail(f"{what}: graph equal to eager {same}, eager "
                         f"equal to the block {torch.equal(eager, x)}, "
                         f"{replays} replays")
                del eager
            emit({"reshard_graph": {"mesh": list(m), "size": size,
                                    "dtype": dtype, "round_trips": n,
                                    "arms": list(rs.ARMS), "bitwise": True,
                                    "elapsed_s": time.perf_counter() - T0}})
            del x
            torch.cuda.empty_cache()


def drive_attention(torch, counters) -> None:
    """Phase 4, ``attention`` at JAX's defaults on a ring of one rank per
    ATTENTION_RUNS (NCCL group of one: the ring makes no hop, Ulysses'
    all-to-all moves nothing): every row verified against the NumPy
    golden, timed as graph replays, no kernel of the port launched; its
    TFLOP/s printed."""
    for impl, causal, dtype in ATTENTION_RUNS:
        argv = ["attention", "--impl", impl, "--dtype", dtype,
                "--n-devices", "1", *(["--causal"] if causal else [])]
        rows, counts = _run_counted(counters, argv)
        what = " ".join(argv)
        if len(rows) != 1:
            fail(f"{what}: {len(rows)} rows")
        (r,) = rows
        _want_row(what, r, {
            "platform": "cuda", "verified": True, "dispatch": "graph",
            "workload": f"attention-{impl}", "mesh": [1], "causal": causal,
            "dtype": dtype, "size": [4096, 8, 128]})
        if not isinstance(r.get("tflops"), float):
            fail(f"{what}: tflops {r.get('tflops')}")
        _want_launched(what, counts, set())
        emit({"attention": {
            "impl": impl, "causal": causal, "dtype": dtype,
            **{k: r[k] for k in ("secs_per_iter", "tflops", "graph_steps",
                                 "ring_bytes_per_chip_per_iter")},
            "elapsed_s": time.perf_counter() - T0}})


def check_attention_graph(torch) -> None:
    """Phase 4, the float32 ring and Ulysses at JAX's defaults (seq 4096,
    8 heads, head_dim 128): ATTENTION_GRAPH_CALLS chained calls replayed
    from a CUDA graph (``GraphLoop``, as the bench's timed loop runs
    them) bitwise equal to the same calls launched eagerly."""
    from tpu_comm_torch.bench.attention import AttnConfig, attention_inputs
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.extras import ring_attention as ra
    from tpu_comm_torch.kernels.graphs import GraphLoop

    n = ATTENTION_GRAPH_CALLS
    with launch.process_group("nccl"):
        q, k, v = (t.cuda() for t in attention_inputs(AttnConfig()))
        for fn in (ra.ring_attention, ra.ulysses_attention):
            eager = q
            for _ in range(n):
                eager = fn(eager, k, v)
            loop = GraphLoop(lambda u, fn=fn: fn(u, k, v), q)
            try:
                loop.run(n)  # eager on a side stream, then the capture
                same = torch.equal(loop.run(n), eager)  # a replay
                replays = loop.graphs[n].replays
            finally:
                loop.release()
            if replays != 1 or not same:
                fail(f"graphed {fn.__name__} 4096x8x128 float32: graph "
                     f"equal to eager {same}, {replays} replays")
            emit({"attention_graph": {"impl": fn.__name__, "calls": n,
                                      "bitwise": True,
                                      "elapsed_s": time.perf_counter() - T0}})
            del eager
        del q, k, v
        torch.cuda.empty_cache()


def measure_graph_turns(torch) -> list:
    """Phase 5, the reshard round trip of each arm on the 8192^2 float32
    mesh of one and the float32 ring attention at JAX's defaults: eager,
    one call an iteration, beside the same iteration replayed from a CUDA
    graph of GRAPH_TURN_ITERS, in turns (:func:`in_turns`, ms an
    iteration)."""
    from tpu_comm_torch.bench.attention import AttnConfig, attention_inputs
    from tpu_comm_torch.bench.reshard import _host_field
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.comm import reshard as rs
    from tpu_comm_torch.extras import ring_attention as ra
    from tpu_comm_torch.kernels.graphs import GraphLoop

    n = GRAPH_TURN_ITERS
    rows = []

    def turns(what: str, body, x) -> None:
        loop = GraphLoop(body, x)
        try:
            loop.run(n)  # eager on a side stream, then the capture
            got = in_turns(torch, {
                "eager": lambda: body(x),
                "graph": loop.graphs[n].dispatch,
            }, timer=lambda label, fn: time_ms(
                torch, fn, n if label == "eager" else DIST_GRAPH_REPS))
        finally:
            loop.release()
        graph = {k: v / n if k != "runs" else [r / n for r in v]
                 for k, v in got["graph"].items()}
        rows.append({"what": what, "eager_ms": got["eager"]["ms"],
                     "eager_spread_ms": got["eager"]["spread_ms"],
                     "graph_ms": graph["ms"],
                     "graph_spread_ms": graph["spread_ms"],
                     "graph_iters": n, "rounds": MEMBW_ROUNDS})
        emit({"graph_turns": {**rows[-1],
                              "elapsed_s": time.perf_counter() - T0}})

    with launch.process_group("nccl"):
        gshape = (SIZES[2],) * 2
        x = _host_field(gshape, torch.float32).cuda()
        plan = rs.plan_reshard(gshape, (1, 1), (1, 1), 4)
        for arm in rs.ARMS:
            def trip(u, arm=arm):
                return rs.reshard_block(rs.reshard_block(u, plan, arm),
                                        plan, arm)
            turns(f"reshard {arm} round trip 1,1 {SIZES[2]} float32", trip,
                  x)
        del x
        q, k, v = (t.cuda() for t in attention_inputs(AttnConfig()))
        turns("attention ring 4096x8x128 float32",
              lambda u: ra.ring_attention(u, k, v), q)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def library_call(torch, key: int):
    """One PyTorch call computing the periodic stencil: a circular-padded
    convolution with the stencil's weights (the box: every cell of the
    3^d cube but the centre)."""
    dim = DIM[key]
    conv = {1: torch.nn.Conv1d, 2: torch.nn.Conv2d, 3: torch.nn.Conv3d}[dim](
        1, 1, 3, padding=1, padding_mode="circular", bias=False,
    ).cuda()
    w = torch.zeros((1, 1) + (3,) * dim, device="cuda")
    if key in BOX:
        w.fill_(1.0 / (3 ** dim - 1))
        w[(0, 0) + (1,) * dim] = 0.0
    else:
        for axis in range(dim):
            for side in (0, 2):
                idx = [0, 0] + [1] * dim
                idx[2 + axis] = side
                w[tuple(idx)] = 1.0 / (2 * dim)
    with torch.no_grad():
        conv.weight.copy_(w)
    return conv


def measure_times(torch, mods, arm: str) -> dict:
    """Phase 5: per-step times of the ``arm`` kernels at the full float32
    sizes."""
    from tpu_comm_torch.kernels import membw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for key in KERNELS[arm]:
        mod, dim = mods[key], DIM[key]
        shape = (SIZES[dim],) * dim
        u = random_field(torch, shape, torch.float32, seed=10 + key)
        dst = torch.empty_like(u)
        n = u.numel()
        step = mod.STEPS[arm]
        kernel_ms = time_ms(torch, lambda: step(u, "dirichlet", out=dst), 50)
        periodic_ms = None
        if "periodic" in ARM_BCS.get(arm, ("periodic",)):
            periodic_ms = time_ms(
                torch, lambda: step(u, "periodic", out=dst), 50)
        plain_ms = time_ms(
            torch, lambda: mod.step_plain(u, "dirichlet", out=dst), 10)
        chunk_sweep_ms = {
            str(c): time_ms(torch, lambda: step(
                u, "dirichlet", rows_per_chunk=c, out=dst), 50)
            for c in CHUNK_SWEEP.get(arm, {}).get(key, ())}
        copy_ms = time_ms(torch, lambda: dst.copy_(u), 50)
        flat_u, flat_dst = u.reshape(-1), dst.reshape(-1)
        chunked_copy_ms = time_ms(
            torch, lambda: membw.step_chunked(flat_u, None, 1.0, "copy",
                                              out=flat_dst), 50)
        conv = library_call(torch, key)
        x = u.reshape((1, 1) + shape)
        with torch.no_grad():
            library_ms = time_ms(torch, lambda: conv(x), 10)
            lib_err = float(
                (conv(x).reshape(shape) - mod.step_plain(u, "periodic"))
                .abs().max()
            )
        nbytes = 2 * n * u.element_size()
        ops = OPS_PER_POINT[key] * n
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
        out[key] = {
            "kernel": KERNELS[arm][key][0], "shape": list(shape),
            "dtype": "float32", "bc": "dirichlet",
            "kernel_ms": kernel_ms, "kernel_periodic_ms": periodic_ms,
            **({"chunk_sweep_ms": chunk_sweep_ms} if chunk_sweep_ms else {}),
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": f"torch.nn.Conv{dim}d(padding_mode='circular')",
            "library_max_abs_err": lib_err,
            "copy_ms": copy_ms,
            # the repo's own roofline rule: the port's own measured copy
            # (membw_unary) at the same bytes, the denominator the JAX
            # package reads its stencil numbers against
            "chunked_copy_ms": chunked_copy_ms,
            "kernel_over_chunked_copy": kernel_ms / chunked_copy_ms,
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        emit({"times": {**out[key], "elapsed_s": time.perf_counter() - T0}})
        del u, dst, x, conv, flat_u, flat_dst
        torch.cuda.empty_cache()
    return out


#: the wrapper's label among the pack's turns: back-to-back calls, the
#: host's time a call (every other label is device time, queued)
PACK_CALL = "pack_faces call"
#: queued calls of each pack run, and back-to-back calls of ``call_ms``
PACK_REPS = 50
#: the row lengths phase 5 also packs 512 x 512 rows of (float32): the
#: x-face cells 1 KiB to 32 bytes apart
PACK_NX_SWEEP = (256, 128, 64, 32, 16, 8)
#: bytes a copy moves to flush the 50 MB L2 before a cold pack
PACK_FLUSH_BYTES = 128 << 20


def measure_pack(torch) -> dict:
    """Phase 5, face pack at 512^3 in float32 and bfloat16, in turns
    (:func:`in_turns`, median of MEMBW_ROUNDS and spread): the kernel,
    the plain version, the four ``.contiguous()`` slices as the library
    yardstick and a ``copy_`` of the faces' bytes, each as device time
    (:func:`queued_ms`), and the wrapper's back-to-back call time
    (``call_ms``, :data:`PACK_CALL`). Returns the float32 row."""
    from tpu_comm_torch.kernels import pack

    nz = ny = nx = SIZES[3]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        u = random_field(torch, (nz, ny, nx), dtype, seed=41)
        item = u.element_size()
        faces = (2 * nz * nx + 2 * nz * ny) * item
        copy_src = torch.empty(faces // item, device="cuda", dtype=dtype)
        copy_dst = torch.empty_like(copy_src)
        big = torch.empty_like(u)
        flush_src = torch.empty(PACK_FLUSH_BYTES, device="cuda",
                                dtype=torch.uint8)
        flush_dst = torch.empty_like(flush_src)

        def filler():  # ~8 ms of copies: room to enqueue the calls
            for _ in range(96 // item):
                big.copy_(u)

        def library():
            return (u[:, 0, :].contiguous(), u[:, -1, :].contiguous(),
                    u[:, :, 0].contiguous(), u[:, :, -1].contiguous())

        def timer(label, fn):
            # the pack takes microseconds on the card, less than its Python
            # call: back-to-back calls time the host, queued calls the card
            if label == PACK_CALL:
                return time_ms(torch, fn, PACK_REPS)
            ms, queued = queued_ms(torch, fn, PACK_REPS, filler)
            if not queued:
                fail(f"pack timing: the host fell behind the filler ({label})")
            return ms

        def flush():  # evicts u's face sectors, leaves the L2 dirty
            flush_dst.copy_(flush_src)

        def read_flush():  # evicts them, leaves the L2 clean
            torch.sum(flush_src, dtype=torch.int32)

        calls = {"pack_faces": lambda: pack.pack_faces(u),
                 "pack_faces_plain": lambda: pack.pack_faces_plain(u),
                 "four .contiguous()": library,
                 "copy_": lambda: copy_dst.copy_(copy_src),
                 PACK_CALL: lambda: pack.pack_faces(u),
                 "L2 flush": flush,
                 "L2 flush, pack_faces": lambda: (flush(),
                                                  pack.pack_faces(u)),
                 "L2 read flush": read_flush,
                 "L2 read flush, pack_faces": lambda: (read_flush(),
                                                       pack.pack_faces(u))}
        t = in_turns(torch, calls, timer=timer)
        nbytes = pack_bytes((nz, ny, nx), item)
        name = str(dtype).removeprefix("torch.")
        rows[name] = {
            "kernel": PACK_KERNEL[0], "shape": [nz, ny, nx], "dtype": name,
            "rounds": MEMBW_ROUNDS,
            "kernel_ms": t["pack_faces"]["ms"],
            "kernel_spread_ms": t["pack_faces"]["spread_ms"],
            "call_ms": t[PACK_CALL]["ms"],
            "call_spread_ms": t[PACK_CALL]["spread_ms"],
            "plain_ms": t["pack_faces_plain"]["ms"],
            "library_ms": t["four .contiguous()"]["ms"],
            "library_call": "four u[:, 0, :].contiguous()-style slice copies",
            "copy_ms": t["copy_"]["ms"],
            # the pack on a cold L2 full of dirty lines, as the mesh step
            # finds it after the update kernel wrote the block: the
            # flushed pack's time less the flush's; and on a cold clean L2
            "kernel_cold_ms": (t["L2 flush, pack_faces"]["ms"]
                               - t["L2 flush"]["ms"]),
            "kernel_cold_clean_ms": (t["L2 read flush, pack_faces"]["ms"]
                                     - t["L2 read flush"]["ms"]),
            "times": {label: {k: v[k] for k in ("ms", "spread_ms", "runs")}
                      for label, v in t.items()},
            "bytes": nbytes, "ops": 0,
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
        }
        emit({"pack_turns": {**rows[name],
                             "elapsed_s": time.perf_counter() - T0}})
        del u, copy_src, copy_dst, big, flush_src, flush_dst
        torch.cuda.empty_cache()
    return rows["float32"]


def pack_bytes(shape, item: int) -> int:
    """The face pack's modelled bytes: a DRAM sector read per x-face
    element (one a row where the row fits in a sector), the y rows read,
    the four faces written."""
    nz, ny, nx = shape
    x_sectors = 2 if nx * item > SECTOR_BYTES else 1
    return nz * ny * x_sectors * SECTOR_BYTES + 2 * nz * nx * item + (
        2 * nz * nx + 2 * nz * ny) * item


def measure_pack_spacing(torch) -> dict:
    """Phase 5, the face-pack kernel in float32, in turns (:func:`in_turns`,
    device time queued as in :func:`measure_pack`): at 512^3 beside the
    narrower rows of PACK_NX_SWEEP (the same 512 x 512 rows, so the same
    count of x-face cells, closer together). Returns label -> ms and
    spread."""
    from tpu_comm_torch.kernels import pack

    full = (SIZES[3],) * 3
    u = random_field(torch, full, torch.float32, seed=41)
    big = torch.empty_like(u)
    narrow = {nx: random_field(torch, full[:2] + (nx,), torch.float32,
                               seed=42) for nx in PACK_NX_SWEEP}

    def filler():
        for _ in range(24):
            big.copy_(u)

    def timer(label, fn):
        ms, queued = queued_ms(torch, fn, PACK_REPS, filler)
        if not queued:
            fail(f"pack timing: the host fell behind the filler ({label})")
        return ms

    calls = {f"nx = {full[2]}": lambda: pack.pack_faces(u)}
    for nx, v in narrow.items():
        calls[f"nx = {nx}"] = lambda v=v: pack.pack_faces(v)
    t = in_turns(torch, calls, timer=timer)
    out = {}
    for nx in (full[2],) + PACK_NX_SWEEP:
        nbytes = pack_bytes(full[:2] + (nx,), 4)
        out[f"nx = {nx}"] = {
            "ms": t[f"nx = {nx}"]["ms"],
            "spread_ms": t[f"nx = {nx}"]["spread_ms"], "bytes": nbytes,
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
    emit({"pack_spacing": {"rows": list(full[:2]), "dtype": "float32",
                           "rounds": MEMBW_ROUNDS, "times": out,
                           "elapsed_s": time.perf_counter() - T0}})
    del u, big, narrow
    torch.cuda.empty_cache()
    return out


def measure_ghost(torch, mods) -> dict:
    """Phase 5, the ghost-fed wave kernels at the full float32 sizes with
    random ghost lines: kernel (also at other ring blocks), plain
    version, copies of the same bytes, and one convolution of the
    ghost-padded block (prebuilt) with the star's weights, TF32 off: the
    same function, a yardstick the port never calls."""
    import torch.nn.functional as F

    from tpu_comm_torch.kernels import membw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for key, (name, _) in GHOST_KERNELS.items():
        mod, dim = mods[key], DIM[key]
        shape = (SIZES[dim],) * dim
        u = random_field(torch, shape, torch.float32, seed=90 + key)
        g = ghost_lines(torch, shape, torch.float32, seed=95)
        dst = torch.empty_like(u)
        n = u.numel()
        kernel_ms = time_ms(torch, lambda: mod.step_wave_ghost(
            u, *g, out=dst), 50)
        plain_ms = time_ms(torch, lambda: mod.step_wave_ghost_plain(
            u, *g, out=dst), 10)
        chunk_sweep_ms = {
            str(c): time_ms(torch, lambda: mod.step_wave_ghost(
                u, *g, rows_per_chunk=c, out=dst), 50)
            for c in CHUNK_SWEEP["wave"][key]}
        copy_ms = time_ms(torch, lambda: dst.copy_(u), 50)
        flat_u, flat_dst = u.reshape(-1), dst.reshape(-1)
        chunked_copy_ms = time_ms(
            torch, lambda: membw.step_chunked(flat_u, None, 1.0, "copy",
                                              out=flat_dst), 50)
        # the block padded with its ghost lines (2D: zero corners, which
        # the star's weights never read)
        if dim == 1:
            padded = torch.cat([g[0], u, g[1]])
            w = torch.tensor([0.5, 0.0, 0.5], device="cuda")
            conv = F.conv1d
        else:
            padded = torch.zeros((shape[0] + 2, shape[1] + 2), device="cuda")
            padded[1:-1, 1:-1] = u
            padded[0, 1:-1], padded[-1, 1:-1] = g[0][0], g[1][0]
            padded[1:-1, 0], padded[1:-1, -1] = g[2][:, 0], g[3][:, 0]
            w = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                              [0.0, 0.25, 0.0]], device="cuda")
            conv = F.conv2d
        x = padded.reshape((1, 1) + padded.shape)
        w = w.reshape((1, 1) + w.shape)
        library_ms = time_ms(torch, lambda: conv(x, w), 10)
        lib_err = float((conv(x, w).reshape(shape)
                         - mod.step_wave_ghost_plain(u, *g)).abs().max())
        ghost_elems = sum(t.numel() for t in g)
        nbytes = (2 * n + ghost_elems) * u.element_size()
        ops = OPS_PER_POINT[key] * n
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
        out[key] = {
            "kernel": name, "shape": list(shape), "dtype": "float32",
            "kernel_ms": kernel_ms, "chunk_sweep_ms": chunk_sweep_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": f"torch.nn.functional.conv{dim}d of the "
                            "ghost-padded block with the star's weights",
            "library_max_abs_err": lib_err,
            "copy_ms": copy_ms, "chunked_copy_ms": chunked_copy_ms,
            "kernel_over_chunked_copy": kernel_ms / chunked_copy_ms,
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        emit({"times": {**out[key], "elapsed_s": time.perf_counter() - T0}})
        del u, g, dst, x, padded, flat_u, flat_dst
        torch.cuda.empty_cache()
    return out


#: the distributed steps phase 5 times: (key, arm, --pack, options), each
#: eager and as a CUDA graph replay in turns; the 3D block steps with
#: each pack are also timed in turns with each other (PACK_STEPS)
DIST_STEPS = [(1, "block", "fused", {}), (2, "block", "fused", {}),
              (3, "block", "kernel", {}), (3, "block", "fused", {}),
              (3, "stream", "kernel", {}), (3, "overlap", "kernel", {}),
              (3, "torch", "fused", {}), (3, "multi", "fused", {}),
              (2, "partitioned", "fused", {"halo_parts": 4}),
              (2, "overlap", "fused", {"halo_width": 4}),
              (3, "block", "kernel", {"halo_wire": "bfloat16"}),
              (9, "block", "fused", {}), (9, "stream", "fused", {}),
              (9, "overlap", "fused", {}), (9, "multi", "fused", {}),
              (27, "block", "fused", {}), (27, "stream", "fused", {}),
              (27, "overlap", "fused", {}), (27, "multi", "fused", {}),
              (1, "wave", "fused", {}), (2, "wave", "fused", {}),
              (3, "wave", "fused", {}), (9, "wave", "fused", {}),
              (27, "wave", "fused", {})]
#: steps of the graph a phase 5 step is replayed in (a multi trip is
#: MESH_MULTI_T steps, a deep-halo trip a window)
DIST_GRAPH_STEPS = 20
#: replays a timing of the graphed step makes
DIST_GRAPH_REPS = 3
#: the 3D block step with the face-pack kernel and with views, timed in
#: turns with each other (:func:`measure_pack_steps`)
PACK_STEPS = [(3, "block", "kernel"), (3, "block", "fused")]


def dist_kernel(torch, mods, key: int, impl: str, u, dst):
    """The update kernel of a mesh arm's step alone, as a call on ``u``:
    the block-periodic step (block, stream); for the wave arm the
    ghost-fed kernel with random ghost lines (1D, 2D), the wavefront at
    t = 1 (3D) or the box's wave; None for the arms without a kernel."""
    mod = mods[key]
    if impl == "wave":
        if key in GHOST_KERNELS:
            g = ghost_lines(torch, tuple(u.shape), u.dtype, seed=97)
            return lambda: mod.step_wave_ghost(u, *g, out=dst)
        if key == 3:
            return lambda: mod.step_multi(u, "dirichlet", 1, out=dst)
        return lambda: mod.step_wave(u, "dirichlet", out=dst)
    if impl in KERNELS:
        return lambda: mod.STEPS[impl](u, "periodic", out=dst)
    return None


def dist_exchange(key: int, impl: str, pack: str, t: int, u, cart):
    """The exchange of a mesh arm's step alone (pack, post, wait), as a
    call; None for the torch arm (its chained pad_halo has no such
    part)."""
    from tpu_comm_torch.comm import halo

    if impl == "torch":
        return None
    if impl == "multi":
        return lambda: halo.start_exchange_transitive(u, cart, t).wait()
    if key in BOX:
        return lambda: halo.start_exchange_transitive(u, cart).wait()
    if pack == "kernel":
        return lambda: halo.start_exchange_ghosts_3d_packed(u, cart).wait()
    return lambda: halo.start_exchange_ghosts(u, cart).wait()


def measure_dist_steps(torch, mods) -> list:
    """Phase 5, the whole distributed step at full float32 size on a mesh
    of one (exchange through NCCL, update, face recompute, freeze) per
    (stencil, arm, pack, options) of DIST_STEPS and bc: eager, one call a
    step as the CPU runs it, beside the same step replayed from a CUDA
    graph of DIST_GRAPH_STEPS steps as a card run dispatches it, in turns
    (:func:`in_turns`); the graph's chain held bitwise to the eager
    chain; and beside them the update kernel alone and the exchange
    alone. A ``multi`` step (t = MESH_MULTI_T) is one width-t exchange
    and t updates, a deep-halo step a window of ``halo_width``: its time
    per iteration is a t-th of it."""
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.kernels import launch_wrappers, stencil_name
    from tpu_comm_torch.kernels.distributed import (
        GraphChain,
        _run_eager,
        _step_and_trips,
    )
    from tpu_comm_torch.topo import make_cart_mesh

    rows = []
    wrappers = launch_wrappers()
    with launch.process_group("nccl"):
        for key, impl, pack, opts in DIST_STEPS:
            dim = DIM[key]
            shape = (SIZES[dim],) * dim
            u = random_field(torch, shape, torch.float32, seed=42)
            dst = torch.empty_like(u)
            points = key if key in BOX else 0
            t = (MESH_MULTI_T if impl == "multi"
                 else opts.get("halo_width", 1))
            extra = dict(opts, **({"t_steps": t} if impl == "multi" else {}))
            trips = DIST_GRAPH_STEPS // t
            for bc in ("dirichlet", "periodic"):
                cart = make_cart_mesh(dim, periodic=bc == "periodic")
                # the deep window takes its own options only
                step_opts = extra if "halo_width" in opts else dict(
                    extra, pack=pack, stencil=stencil_name(points))
                step, _ = _step_and_trips(cart, bc, impl, step_opts, t)
                chain = GraphChain(step, trips, torch.empty_like(u),
                                   torch.empty_like(u))
                try:
                    chain.x.copy_(u)
                    chain.dispatch()  # the eager warm-up, then the capture
                    chain.x.copy_(u)
                    chain.dispatch()  # a replay
                    before = [w.launches for w in wrappers]
                    want = _run_eager(step, u, trips)
                    eager = {w: w.launches - b for w, b in
                             zip(wrappers, before) if w.launches != b}
                    what = f"graphed {_workload(key)} {impl} {opts} {bc}"
                    if not torch.equal(chain.x, want):
                        fail(f"{what} differs from the eager chain by "
                             f"{(chain.x - want).abs().max().item()}")
                    if chain.captured != eager:
                        fail(f"{what}: a replay launches "
                             f"{_named(chain.captured)}, the eager chain "
                             f"{_named(eager)}")
                    del want
                    turns = in_turns(torch, {
                        "eager": lambda: step(u, out=dst),
                        "graph": chain.dispatch,
                    }, timer=lambda label, fn: time_ms(
                        torch, fn, trips if label == "eager"
                        else DIST_GRAPH_REPS))
                finally:
                    chain.release()
                eager = turns["eager"]
                graph = {k: v / trips if k != "runs" else
                         [r / trips for r in v]
                         for k, v in turns["graph"].items()}
                exchange = (None if opts else
                            dist_exchange(key, impl, pack, t, u, cart))
                exchange_ms = None if exchange is None else time_ms(
                    torch, exchange, 20)
                kernel = dist_kernel(torch, mods, key, impl, u, dst)
                kernel_ms = None if kernel is None else time_ms(
                    torch, kernel, 20)
                rows.append({"stencil": _workload(key), "impl": impl,
                             "pack": pack, **opts, "bc": bc,
                             "shape": list(shape), "dtype": "float32",
                             "t_steps": t, "rounds": MEMBW_ROUNDS,
                             "dist_step_ms": eager["ms"],
                             "dist_step_spread_ms": eager["spread_ms"],
                             "dist_step_ms_per_iter": eager["ms"] / t,
                             "graph_step_ms": graph["ms"],
                             "graph_step_spread_ms": graph["spread_ms"],
                             "graph_step_ms_per_iter": graph["ms"] / t,
                             "graph_steps": trips * t,
                             "graph_bitwise": True,
                             "launches_a_replay": _named(chain.captured),
                             "kernel_ms": kernel_ms,
                             "exchange_ms": exchange_ms})
                emit({"dist_step": {**rows[-1],
                                    "elapsed_s": time.perf_counter() - T0}})
            del u, dst
            torch.cuda.empty_cache()
    return rows


def measure_pack_steps(torch, mods) -> list:
    """Phase 5, the 3D block step on a mesh of one at 512^3 float32 with
    each pack of PACK_STEPS, in turns with each other (:func:`in_turns`,
    median of MEMBW_ROUNDS and spread), each bc: the whole step, its
    exchange alone and, once, the block kernel alone."""
    from tpu_comm_torch.comm import launch
    from tpu_comm_torch.kernels.distributed import make_local_step
    from tpu_comm_torch.topo import make_cart_mesh

    rows = []
    shape = (SIZES[3],) * 3
    u = random_field(torch, shape, torch.float32, seed=42)
    dst = torch.empty_like(u)
    with launch.process_group("nccl"):
        for bc in ("dirichlet", "periodic"):
            cart = make_cart_mesh(3, periodic=bc == "periodic")
            calls = {"jacobi3d_block": dist_kernel(torch, mods, 3, "block",
                                                   u, dst)}
            for key, impl, pack in PACK_STEPS:
                step = make_local_step(cart, bc, impl, pack=pack)
                calls[f"{impl} --pack {pack} step"] = (
                    lambda step=step: step(u, out=dst))
                calls[f"{impl} --pack {pack} exchange"] = dist_exchange(
                    key, impl, pack, 1, u, cart)
            t = in_turns(torch, calls)
            for key, impl, pack in PACK_STEPS:
                step, exchange = (t[f"{impl} --pack {pack} {part}"]
                                  for part in ("step", "exchange"))
                rows.append({
                    "stencil": _workload(key), "impl": impl, "pack": pack,
                    "bc": bc, "shape": list(shape), "dtype": "float32",
                    "t_steps": 1, "rounds": MEMBW_ROUNDS,
                    "dist_step_ms": step["ms"],
                    "dist_step_spread_ms": step["spread_ms"],
                    "dist_step_ms_per_iter": step["ms"],
                    "kernel_ms": t["jacobi3d_block"]["ms"],
                    "kernel_spread_ms": t["jacobi3d_block"]["spread_ms"],
                    "exchange_ms": exchange["ms"],
                    "exchange_spread_ms": exchange["spread_ms"]})
                emit({"dist_step": {**rows[-1],
                                    "elapsed_s": time.perf_counter() - T0}})
    del u, dst
    torch.cuda.empty_cache()
    return rows


def check_multi(torch, mods) -> dict:
    """Phase 3, temporal blocking: each multi kernel against its plain
    version, bitwise; returns the max abs error per stencil key (0.0 when
    every case was equal)."""
    from tpu_comm_torch.kernels import run_steps
    from tpu_comm_torch.kernels.tiling import MULTI_T_MAX

    errs = {}
    for key, (name, _) in MULTI_KERNELS.items():
        mod, dim = mods[key], DIM[key]
        full = (SIZES[dim],) * dim
        t_pass = MULTI_T_OF.get(key, MULTI_T)
        t_over = 2 * MULTI_T_MAX[dim] + 3
        worst = 0.0
        cases = 0

        def hold(got, want, what):
            nonlocal worst, cases
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            cases += 1
            if got.dtype != want.dtype or not torch.equal(got, want):
                fail(f"{name} {what}: kernel != plain (max abs err {err})")

        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for bc in MULTI_BCS.get(key, ("dirichlet", "periodic")):
                u = random_field(torch, full, dtype, seed=50 + dim)
                hold(mod.run_multi(u, MULTI_PASSES * t_pass, bc,
                                   t_steps=t_pass),
                     run_steps(mod.step_multi_plain, u, MULTI_PASSES, bc,
                               t_steps=t_pass),
                     f"{full} {dtype} {bc} {MULTI_PASSES} passes of "
                     f"t={t_pass}")
                one = mod.step_multi(u, bc, 1)
                hold(one, mod.step_multi_plain(u, bc, 1),
                     f"{full} {dtype} {bc} t=1")
                if dtype == torch.float32:
                    hold(one, mod.step_block(u, bc),
                         f"{full} {bc} t=1 against the block kernel")
                before = mod.step_multi.launches
                got = mod.step_multi(u, bc, t_over)
                if mod.step_multi.launches - before != 3:
                    fail(f"{name} t={t_over}: expected 3 chained launches")
                hold(got, mod.step_multi_plain(u, bc, t_over),
                     f"{full} {dtype} {bc} t={t_over} (chained)")
                if dtype == torch.float32:
                    ref = mod.step_multi(u, bc, t_pass)
                    for tile in MULTI_ODD_TILES[dim]:
                        hold(mod.step_multi(u, bc, t_pass, **tile), ref,
                             f"{full} {bc} tile {tile}")
                    del ref
                    # every t a launch of the 2D and 3D kernels takes
                    for t in (range(1, MULTI_T_MAX[dim] + 1) if dim > 1
                              else ()):
                        hold(mod.step_multi(u, bc, t),
                             mod.step_multi_plain(u, bc, t),
                             f"{full} {bc} t={t}")
                if dim > 1 and dtype != torch.float16:
                    # views off the 16-byte grid, in and out: the 2D
                    # kernel's scalar loads and stores
                    n = u.numel()
                    base = random_field(torch, (n + 8,), dtype, seed=55)
                    view = base[1:1 + n].view(full)
                    dst = torch.empty(n + 1, dtype=dtype,
                                      device="cuda")[1:].view(full)
                    hold(mod.step_multi(view, bc, t_pass, out=dst),
                         mod.step_multi_plain(view, bc, t_pass),
                         f"{full} {dtype} {bc} t={t_pass} off the 16-byte "
                         f"grid")
                    del base, view, dst
                del u, one, got
                for shape in RAGGED[dim] + ([(2, 3, 3)] if dim == 3
                                            else []):
                    u = random_field(torch, shape, dtype, seed=60 + dim)
                    for t in (3, MULTI_T):
                        hold(mod.step_multi(u, bc, t),
                             mod.step_multi_plain(u, bc, t),
                             f"{shape} {dtype} {bc} t={t}")
            torch.cuda.empty_cache()
        errs[key] = worst
        emit({"check": {"kernel": name, "cases": cases,
                        "shapes": [list(full)] + RAGGED[dim],
                        "bcs": list(MULTI_BCS.get(key, ("dirichlet",
                                                        "periodic"))),
                        "t_steps": sorted(
                            {1, 3, t_pass, MULTI_T, t_over}
                            | set(range(1, MULTI_T_MAX[dim] + 1)
                                  if dim > 1 else ())),
                        "offset_views": dim > 1,
                        "max_abs_err": worst,
                        "tolerance": "bitwise (torch.equal)",
                        "elapsed_s": time.perf_counter() - T0}})
    return errs


def drive_multi(torch, counters) -> dict:
    """Phase 4, temporal blocking on one device: ``stencil --impl multi``
    at full size per multi family and bc; each run must launch its
    kernel once a pass and no other. Returns each kernel's launches."""
    from tpu_comm_torch import cli

    launches = {name: 0 for name, _ in MULTI_KERNELS.values()}
    warmup, reps = 3, 10
    with tempfile.TemporaryDirectory() as tmp:
        for key, (name, _) in MULTI_KERNELS.items():
            t = MULTI_T_OF.get(key, MULTI_T)
            for bc in MULTI_BCS.get(key, ("dirichlet", "periodic")):
                path = Path(tmp) / f"multi{key}-{bc}.jsonl"
                for w in counters.values():
                    w.launches = 0
                argv = ["stencil", *_stencil_argv(key), "--size",
                        str(SIZES[DIM[key]]), "--impl", "multi",
                        "--t-steps", str(t), "--iters",
                        str(MULTI_ITERS), "--bc", bc, "--verify",
                        "--verify-iters", str(VERIFY_ITERS), "--warmup",
                        str(warmup), "--reps", str(reps), "--jsonl",
                        str(path)]
                rc = cli.main(argv)
                counts = {k: w.launches for k, w in counters.items()}
                what = " ".join(argv[1:-2])
                if rc != 0:
                    fail(f"{what} exited {rc}")
                row = json.loads(path.read_text().splitlines()[-1])
                want = {"platform": "cuda", "verified": True,
                        "impl": "multi", "t_steps": t,
                        "workload": _workload(key)}
                got = {k: row.get(k) for k in want}
                if got != want:
                    fail(f"{what}: row says {got}, expected {want}")
                # the verify run's passes (its iterations rounded up to
                # t), then iters/t and 3*iters/t a timed loop
                passes = -(-VERIFY_ITERS // t) + (
                    (warmup + reps) * 4 * MULTI_ITERS // t)
                if counts[name] != passes:
                    fail(f"{what}: {name} launched {counts[name]} times, "
                         f"expected {passes} (one a pass)")
                if any(c for k, c in counts.items() if k != name):
                    fail(f"{what} launched other kernels: {counts}")
                launches[name] += counts[name]
                emit({"main_path": {
                    "stencil": _workload(key), "impl": "multi", "bc": bc,
                    "t_steps": t, "launches": counts[name],
                    "gbps_eff": row["gbps_eff"],
                    "secs_per_iter": row["secs_per_iter"],
                    "elapsed_s": time.perf_counter() - T0}})
    return launches


def composed_weights(torch, key: int, t: int):
    """The stencil's weights convolved with themselves t times, in
    float64 on the host: the (2t+1)^d kernel of t periodic steps."""
    import torch.nn.functional as F

    dim = DIM[key]
    w = torch.zeros((1, 1) + (3,) * dim, dtype=torch.float64)
    if key in BOX:
        w.fill_(1.0 / (3 ** dim - 1))
        w[(0, 0) + (1,) * dim] = 0.0
    else:
        for axis in range(dim):
            for side in (0, 2):
                idx = [0, 0] + [1] * dim
                idx[2 + axis] = side
                w[tuple(idx)] = 1.0 / (2 * dim)
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[dim]
    k = w
    for _ in range(t - 1):  # the weights are symmetric: no flip needed
        k = conv(F.pad(k, (2,) * (2 * dim)), w)
    return k.float()


def multi_turn_calls(mod, u, dst, key: int, t: int) -> dict:
    """The calls :func:`measure_multi` times in turns for a multi family:
    a pass of ``t`` steps (``multi``), the same stencil's block kernel
    called ``t`` times (``block_x{t}``, ping-pong between two scratch
    fields: the control a temporal-blocking pass must beat) and ``copy_``
    of the same bytes; for the 3D wavefront also its pass of t = 1 (the
    mesh ``wave`` arm's launch) beside one block step."""
    x, y = u.clone(), u.new_empty(u.shape)

    def blocks(steps: int):
        def run():
            a, b = x, y
            for _ in range(steps):
                mod.step_block(a, "dirichlet", out=b)
                a, b = b, a
        return run

    calls = {"multi": lambda: mod.step_multi(u, "dirichlet", t, out=dst),
             f"block_x{t}": blocks(t),
             "copy_": lambda: dst.copy_(u)}
    if key == 3:
        calls["multi_t1"] = lambda: mod.step_multi(u, "dirichlet", 1,
                                                   out=dst)
        calls["block_x1"] = blocks(1)
    return calls


def measure_multi(torch, mods) -> dict:
    """Phase 5, temporal blocking: per-pass times of the multi kernels at
    t = 8 (3D: 4) at the full float32 sizes, in turns (:func:`in_turns`,
    the median of three and the spread) beside the block kernel called t
    times and ``copy_`` (:func:`multi_turn_calls`); beside them their
    bound, the plain version, the chunked copy of the same bytes and one
    circular convolution with the t-fold composed stencil, and a pass at
    other t and tiles."""
    from tpu_comm_torch.kernels import membw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for key, (name, _) in MULTI_KERNELS.items():
        mod, dim = mods[key], DIM[key]
        t = MULTI_T_OF.get(key, MULTI_T)
        shape = (SIZES[dim],) * dim
        u = random_field(torch, shape, torch.float32, seed=70 + key)
        dst = torch.empty_like(u)
        n = u.numel()
        turns = in_turns(torch, multi_turn_calls(mod, u, dst, key, t))
        kernel_ms = turns["multi"]["ms"]
        periodic_ms = None
        if "periodic" in MULTI_BCS.get(key, ("periodic",)):
            periodic_ms = time_ms(
                torch, lambda: mod.step_multi(u, "periodic", t, out=dst), 30)
        plain_ms = time_ms(
            torch, lambda: mod.step_multi_plain(u, "dirichlet", t, out=dst),
            3)
        copy_ms = time_ms(torch, lambda: dst.copy_(u), 50)
        flat_u, flat_dst = u.reshape(-1), dst.reshape(-1)
        chunked_copy_ms = time_ms(
            torch, lambda: membw.step_chunked(flat_u, None, 1.0, "copy",
                                              out=flat_dst), 50)
        conv = {1: torch.nn.Conv1d, 2: torch.nn.Conv2d,
                3: torch.nn.Conv3d}[dim](
            1, 1, 2 * t + 1, padding=t, padding_mode="circular",
            bias=False).cuda()
        x = u.reshape((1, 1) + shape)
        with torch.no_grad():
            conv.weight.copy_(composed_weights(torch, key, t))
            library_ms = time_ms(torch, lambda: conv(x), 3 if dim == 3
                                 else 5)
            lib_err = float(
                (conv(x).reshape(shape)
                 - mod.step_multi_plain(u, "periodic", t)).abs().max())
        # where the time goes: a pass at other t (its fixed part and its
        # part a step) and at other tiles
        t_sweep_ms = {
            str(k): time_ms(torch, lambda: mod.step_multi(
                u, "dirichlet", k, out=dst), 10)
            for k in MULTI_T_SWEEP[dim]}
        tile_sweep_ms = {
            json.dumps(tile): time_ms(torch, lambda: mod.step_multi(
                u, "dirichlet", t, out=dst, **tile), 10)
            for tile in MULTI_TILE_SWEEP[dim]}
        nbytes = 2 * n * u.element_size()
        ops = t * OPS_PER_POINT[key] * n
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
        out[key] = {
            "kernel": name, "shape": list(shape), "dtype": "float32",
            "bc": "dirichlet", "t_steps": t,
            "t_sweep_ms": t_sweep_ms, "tile_sweep_ms": tile_sweep_ms,
            "turns": turns, "kernel_ms": kernel_ms,
            "kernel_spread_ms": turns["multi"]["spread_ms"],
            "kernel_periodic_ms": periodic_ms,
            "kernel_ms_per_iter": kernel_ms / t,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": f"torch.nn.Conv{dim}d(kernel {2 * t + 1}, "
                            "padding_mode='circular') with the t-fold "
                            "stencil: the same periodic function up to "
                            "rounding",
            "library_max_abs_err": lib_err,
            "copy_ms": copy_ms, "chunked_copy_ms": chunked_copy_ms,
            "kernel_over_chunked_copy": kernel_ms / chunked_copy_ms,
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        emit({"times": {**out[key], "elapsed_s": time.perf_counter() - T0}})
        del u, dst, x, conv, flat_u, flat_dst
        torch.cuda.empty_cache()
    return out


def membw_kernel_of(op: str, arm: str) -> str:
    """The membw kernel an (op, arm) pass launches."""
    if arm == "stream":
        return "membw_stream"
    if arm == "dma":
        return "membw_dma"
    return "membw_unary" if op in ("copy", "scale") else "membw_binary"


def _hold(torch, name: str, got, want, errs: dict, what: str) -> None:
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    errs[name] = max(errs[name], err)
    if got.dtype != want.dtype or not torch.equal(got, want):
        fail(f"{name} {what}: kernel != plain (max abs err {err})")


def check_membw(torch) -> dict:
    """Phase 3, membw: each kernel against its plain version, bitwise;
    returns the max abs error per kernel (0.0 when every case was
    equal)."""
    from tpu_comm_torch.kernels import membw

    errs = {name: 0.0 for name in MEMBW_KERNELS}
    cases = {name: 0 for name in MEMBW_KERNELS}
    for n in (MEMBW_N, MEMBW_RAGGED):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            x = random_field(torch, (n,), dtype, seed=20)
            b = random_field(torch, (n,), dtype, seed=21)
            # the default, an odd and a swept chunk (64 KiB a CTA: several
            # batches a thread), each form out of place and in place; the
            # vector form on the tensors, the scalar form on views off the
            # 16-byte grid
            swept = CHUNKED_SWEEP_KIB[-1] * 1024 // (128 * x.element_size())
            for op in ("copy", "scale", "add", "triad"):
                name = membw_kernel_of(op, "chunked")
                want = membw.step_plain(x, b, MEMBW_S, op)
                for aliased in (False, True):
                    for rows, off in ((None, 0), (MEMBW_ODD_CHUNK, 0),
                                      (swept, 0), (None, 1),
                                      (MEMBW_ODD_CHUNK, 1)):
                        src = x.clone() if aliased else x
                        view = src[off:off + n - 128] if off else src
                        got = membw.step_chunked(
                            view, b[off:off + n - 128] if off else b,
                            MEMBW_S, op, rows, aliased)
                        if aliased and got.data_ptr() != view.data_ptr():
                            fail(f"{name} aliased did not write in place")
                        _hold(torch, name, got,
                              want[off:off + n - 128] if off else want,
                              errs, f"{op} n={n} {dtype} aliased={aliased} "
                              f"chunk={rows} offset={off}")
                        cases[name] += 1
                        del src, view, got
                del want
            want = membw.copy_plain(x)
            # the stream copy's forms: vector (16-byte aligned), scalar (an
            # offset view off the 16-byte grid), each out of place and in
            # place, at the default and an odd chunk
            for aliased in (False, True):
                for rows in (None, MEMBW_ODD_CHUNK):
                    for off in (0, 1):
                        src = x.clone() if aliased else x
                        view = src[off:off + n - 128] if off else src
                        got = membw.step_stream(view, rows, aliased=aliased)
                        if aliased and got.data_ptr() != view.data_ptr():
                            fail("membw_stream aliased did not write in "
                                 "place")
                        _hold(torch, "membw_stream", got,
                              want[off:off + n - 128] if off else want,
                              errs, f"n={n} {dtype} aliased={aliased} "
                              f"chunk={rows} offset={off}")
                        cases["membw_stream"] += 1
                        del src, view, got
            for depth in range(2, membw.DMA_MAX_DEPTH + 1):
                for rows in (None, MEMBW_ODD_CHUNK):
                    got = membw.step_dma(x, rows, depth)
                    _hold(torch, "membw_dma", got, want, errs,
                          f"n={n} {dtype} depth={depth} chunk={rows}")
                    cases["membw_dma"] += 1
                    del got
            del x, b, want
            torch.cuda.empty_cache()
    # offset views of 1024 cells: off the 16-byte grid (scalar form) and
    # one vector in (the vector form from a pointer that is not a
    # tensor's start), in every dtype
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = random_field(torch, (4096,), dtype, seed=23)
        for off in (1, 16 // x.element_size()):
            for aliased in (False, True):
                src = x.clone()
                view = src[off:off + 1024]
                _hold(torch, "membw_stream",
                      membw.step_stream(view, aliased=aliased),
                      x[off:off + 1024], errs,
                      f"offset view x[{off}:{off} + 1024] {dtype} "
                      f"aliased={aliased}")
                cases["membw_stream"] += 1
    # fewer chunks than slots: on the whole card (3 chunks, depth 4) and
    # per CTA (at every depth, 8 KiB slots and chunks for depth - 1 a CTA,
    # one of them ragged)
    props = torch.cuda.get_device_properties(0)
    x = random_field(torch, (128 * 3,), torch.float32, seed=22)
    _hold(torch, "membw_dma", membw.step_dma(x, 1, 4), x, errs,
          "n=384 depth=4 chunk=1 (3 chunks on the card)")
    cases["membw_dma"] += 1
    for depth in range(2, membw.DMA_MAX_DEPTH + 1):
        rows = 16
        plan = membw.dma_plan(
            1, 4, rows, depth, props.multi_processor_count,
            props.shared_memory_per_multiprocessor,
            props.shared_memory_per_block_optin)
        n = plan.per_sm * props.multi_processor_count * (depth - 1) * rows \
            * 128 - 128 * 8
        x = random_field(torch, (n,), torch.float32, seed=22)
        _hold(torch, "membw_dma", membw.step_dma(x, rows, depth), x, errs,
              f"n={n} depth={depth} chunk={rows} ({depth - 1} chunks a "
              "CTA, the last ragged)")
        cases["membw_dma"] += 1
        del x
    for name in MEMBW_KERNELS:
        emit({"check": {"kernel": name, "cases": cases[name],
                        "sizes": [MEMBW_N, MEMBW_RAGGED], "s": MEMBW_S,
                        "max_abs_err": errs[name],
                        "tolerance": "bitwise (torch.equal)",
                        "elapsed_s": time.perf_counter() - T0}})
    return errs


def check_stream_loads(libs) -> None:
    """The stream copy must keep the 1D stencil's neighbour loads: in the
    machine code of each instantiation the library holds, exactly
    :data:`STREAM_FORMS`, count the global loads. A scalar form must
    show three a cell (at least 3); a vector form the 16-byte vector load
    and both run-edge neighbour loads (at least one 128-bit and two
    narrower ones)."""
    import re

    loads = {}
    for fn, part in _sass_functions(libs, "membw"):
        # Itanium mangling: membw_stream[_inplace]I<j|t>Lb<0|1>E
        m = re.search(r"(membw_stream(?:_inplace)?)I([jt])Lb([01])E", fn)
        if m is None:
            if "membw_stream" in fn:
                fail(f"unexpected membw_stream instantiation {fn}")
            continue
        name, width, vec = m.groups()
        kind = "vector" if vec == "1" else "scalar"
        form = f"{name}<{STREAM_WIDTHS[width]}, {kind}>"
        ops = re.findall(r"\bLDG(?:\.[A-Z0-9]+)*", part)
        loads[form] = {"ldg": len(ops),
                       "ldg_128": sum(".128" in op for op in ops)}
    emit({"stream_loads": {"global_loads_per_kernel": loads,
                           "elapsed_s": time.perf_counter() - T0}})
    if set(loads) != set(STREAM_FORMS):
        fail(f"membw_stream instantiations {sorted(loads)} are not "
             f"{sorted(STREAM_FORMS)}")
    for form, got in loads.items():
        if form.endswith("vector>"):
            lost = got["ldg_128"] < 1 or got["ldg"] - got["ldg_128"] < 2
        else:
            lost = got["ldg"] < 3
        if lost:
            fail(f"{form} lost its neighbour loads: {got}")


def _sass_functions(libs, lib: str):
    """``(mangled name, machine code)`` of every kernel in library
    ``lib``, from ``cuobjdump -sass``."""
    from tpu_comm_torch.kernels import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(tool), "-sass", libs[lib]._name], capture_output=True,
        text=True, timeout=120, check=True,
    ).stdout
    for part in sass.split("Function : ")[1:]:
        yield part.split(None, 1)[0], part


def check_chunked_access(libs) -> None:
    """The chunked kernels' instantiations are exactly
    :data:`CHUNKED_FORMS`; in their machine code every vector form keeps
    128-bit global loads and stores (``LDG...128``, ``STG...128``), and
    no form loads through the non-coherent path (``LDG...CONSTANT``): each
    serves in-place calls, where ``out`` is ``x``."""
    import re

    ops = ("copy", "scale", "add", "triad")
    found = {}
    for fn, part in _sass_functions(libs, "membw"):
        m = re.search(r"(membw_(?:unary|binary))"
                      r"I(f|13__nv_bfloat16|6__half)Li([0-3])ELb([01])E", fn)
        if m is None:
            if "membw_unary" in fn or "membw_binary" in fn:
                fail(f"unexpected chunked instantiation {fn}")
            continue
        name, t, op, vec = m.groups()
        form = (f"{name}<{CHUNKED_TYPES[t]}, {ops[int(op)]}, "
                f"{'vector' if vec == '1' else 'scalar'}>")
        loads = re.findall(r"\bLDG(?:\.[A-Z0-9_]+)*", part)
        stores = re.findall(r"\bSTG(?:\.[A-Z0-9_]+)*", part)
        found[form] = {
            "ldg": len(loads), "ldg_128": sum(".128" in i for i in loads),
            "ldg_nc": sum(".CONSTANT" in i for i in loads),
            "stg": len(stores), "stg_128": sum(".128" in i for i in stores),
        }
    emit({"chunked_access": {"global_accesses_per_kernel": found,
                             "elapsed_s": time.perf_counter() - T0}})
    if set(found) != set(CHUNKED_FORMS):
        fail(f"chunked instantiations {sorted(found)} are not "
             f"{sorted(CHUNKED_FORMS)}")
    for form, got in found.items():
        lost = got["ldg"] < 1 or got["stg"] < 1 or got["ldg_nc"] > 0
        if form.endswith("vector>"):
            lost |= got["ldg_128"] < 1 or got["stg_128"] < 1
        if lost:
            fail(f"{form} lost its 128-bit accesses or loads through the "
                 f"non-coherent path: {got}")


#: the instantiations of the redesigned multi kernels in ``multi.cu``:
#: every dtype pair a launch takes (``with_dtypes``), each bc and stencil
#: of the 2D kernel, and each t of the 3D wavefront
MULTI_DTYPE_PAIRS = [("float", "float"), ("__nv_bfloat16", "__nv_bfloat16"),
                     ("__half", "__half"), ("__nv_bfloat16", "float"),
                     ("float", "__nv_bfloat16"), ("__half", "float"),
                     ("float", "__half")]
MULTI2D_FORMS = [f"multi2d_kernel<{a}, {b}, {p}, {box}>"
                 for a, b in MULTI_DTYPE_PAIRS for p in (0, 1)
                 for box in (0, 1)]
MULTI3D_FORMS = [f"jacobi3d_multi_kernel<{a}, {b}, {t}>"
                 for a, b in MULTI_DTYPE_PAIRS for t in (1, 2, 3, 4)]


def _demangle_types(head: str) -> list:
    """The two type arguments that open an Itanium-mangled template
    argument list of the multi kernels (``f``, ``13__nv_bfloat16``,
    ``6__half``, or ``S<n>_`` repeating the first)."""
    import re

    names = {"f": "float", "13__nv_bfloat16": "__nv_bfloat16",
             "6__half": "__half"}
    m = re.match(r"(f|13__nv_bfloat16|6__half)(f|13__nv_bfloat16|6__half"
                 r"|S\d*_)", head)
    if m is None:
        fail(f"cannot read the types of {head}")
    first = names[m.group(1)]
    second = first if m.group(2).startswith("S") else names[m.group(2)]
    return [first, second, head[m.end():]]


#: the local-memory accesses (static ``LDL``/``STL`` instructions) the 2D
#: kernel's dirichlet forms may hold: capped at 168 registers,
#: ptxas spills a few words there (3-14 accesses with CUDA 12.8's nvcc);
#: every other multi form holds none
MULTI2D_DIRICHLET_SPILLS = 16


def check_multi_spills(libs) -> None:
    """The redesigned multi kernels hold their levels in registers: in the
    machine code of each instantiation (exactly :data:`MULTI2D_FORMS` and
    :data:`MULTI3D_FORMS`) no local-memory access (``LDL``/``STL``, a
    spill), but for the 2D dirichlet forms, which hold at most
    :data:`MULTI2D_DIRICHLET_SPILLS`; and the 2D kernel's lanes load and
    store their four float32 columns as one 128-bit access (``LDG...128``
    where it reads float32, ``STG...128`` where it writes float32)."""
    import re

    found = {}
    for fn, part in _sass_functions(libs, "multi"):
        m = re.search(r"(multi2d_kernel|jacobi3d_multi_kernel)I(\w+)", fn)
        if m is None:
            continue
        name = m.group(1)
        tin, tout, rest = _demangle_types(m.group(2))
        if name == "multi2d_kernel":
            mm = re.match(r"Lb([01])ELb([01])E", rest)
            form = f"{name}<{tin}, {tout}, {mm.group(1)}, {mm.group(2)}>"
        else:
            mm = re.match(r"Li(\d+)E", rest)
            form = f"{name}<{tin}, {tout}, {mm.group(1)}>"
        loads = re.findall(r"\bLDG(?:\.[A-Z0-9_]+)*", part)
        stores = re.findall(r"\bSTG(?:\.[A-Z0-9_]+)*", part)
        found[form] = {
            "local": len(re.findall(r"\b(?:LDL|STL)\b", part)),
            "ldg_128": sum(".128" in i for i in loads),
            "stg_128": sum(".128" in i for i in stores),
        }
    emit({"multi_spills": {"accesses_per_kernel": found,
                           "elapsed_s": time.perf_counter() - T0}})
    if set(found) != set(MULTI2D_FORMS + MULTI3D_FORMS):
        fail(f"multi instantiations {sorted(found)} are not "
             f"{sorted(MULTI2D_FORMS + MULTI3D_FORMS)}")
    for form, got in found.items():
        allowed = (MULTI2D_DIRICHLET_SPILLS
                   if re.fullmatch(r"multi2d_kernel<.*, 0, [01]>", form)
                   else 0)
        if got["local"] > allowed:
            fail(f"{form} spills to local memory: {got}, at most "
                 f"{allowed} accesses allowed")
        if form.startswith("multi2d"):
            tin, tout = form.split("<")[1].split(", ")[:2]
            if (tin == "float" and got["ldg_128"] < 1) or (
                    tout == "float" and got["stg_128"] < 1):
                fail(f"{form} lost its 128-bit loads or stores: {got}")


def drive_membw(torch, counters) -> dict:
    """Phase 4, membw: ``membw --op OP --impl ARM`` per pair; returns each
    membw kernel's launches summed over the runs."""
    from tpu_comm_torch import cli

    launches = {name: 0 for name in MEMBW_KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        for op, arm in MEMBW_RUNS:
            path = Path(tmp) / f"membw-{op}-{arm}.jsonl"
            for w in counters.values():
                w.launches = 0
            rc = cli.main(["membw", "--op", op, "--impl", arm,
                           "--jsonl", str(path)])
            counts = {k: w.launches for k, w in counters.items()}
            if rc != 0:
                fail(f"membw --op {op} --impl {arm} exited {rc}")
            rows = [json.loads(line)
                    for line in path.read_text().splitlines()]
            impls = ["chunked", "torch"] if arm == "both" else [arm]
            if [r.get("impl") for r in rows] != impls:
                fail(f"membw --impl {arm} wrote rows {rows}")
            for r in rows:
                if r.get("platform") != "cuda" or r.get("verified") is not True:
                    fail(f"membw {op}/{r.get('impl')}: row says "
                         f"platform={r.get('platform')} "
                         f"verified={r.get('verified')}")
            wrapper = MEMBW_WRAPPER.get(arm)
            if wrapper is not None and counts[wrapper] == 0:
                fail(f"{wrapper} did not launch its kernel in membw --op "
                     f"{op} --impl {arm}")
            if any(c for k, c in counts.items() if k != wrapper):
                fail(f"membw --op {op} --impl {arm} launched other "
                     f"kernels: {counts}")
            if wrapper is not None:
                launches[membw_kernel_of(op, arm)] += counts[wrapper]
            emit({"main_path": {
                "membw": {"op": op, "impl": arm}, "launches": counts,
                "gbps_eff": {r["impl"]: r["gbps_eff"] for r in rows},
                "secs_per_iter": {r["impl"]: r["secs_per_iter"]
                                  for r in rows},
                "elapsed_s": time.perf_counter() - T0}})
    return launches


def in_turns(torch, calls: dict, rounds: int = MEMBW_ROUNDS,
             timer=None) -> dict:
    """``rounds`` runs of each call of ``calls`` (label -> fn), in turns:
    the labels in order in even rounds and reversed in odd ones (copy_,
    kernel, kernel, copy_, ...); ``timer(label, fn)`` times one run, by
    default :func:`time_ms` over 50 calls. Returns label -> the median
    ms, the spread (max - min) and the runs."""
    if timer is None:
        def timer(label, fn):
            return time_ms(torch, fn, 50)
    runs = {label: [] for label in calls}
    for r in range(rounds):
        for label in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            runs[label].append(timer(label, calls[label]))
    return {label: {"ms": statistics.median(v), "spread_ms": max(v) - min(v),
                    "runs": v} for label, v in runs.items()}


def measure_membw(torch, mods) -> dict:
    """Phase 5, membw: per-pass times at 2^26 elements, in turns
    (:func:`in_turns`), in float32 and bfloat16: ``copy_``, the four
    chunked ops each beside its one PyTorch call (:data:`MEMBW_CALLS`)
    and at :data:`CHUNKED_FIXED_ROWS` rows a CTA, the chunked copy through
    its C entry with no Python wrapper, the stream and dma copies; in
    float32 with them the stream copy's
    scalar and in-place forms, the 1D stream and stream2 stencil kernels,
    the chunked copy, scale and triad at other chunks, the stream copy at
    other chunks and the dma ring at other slot sizes and depths. Returns the
    float32 times per (kernel, op)."""
    from tpu_comm_torch.bench import TRAFFIC
    from tpu_comm_torch.kernels import _build, membw
    from tpu_comm_torch.kernels.tiling import KERNEL_DTYPE_CODES

    c_entry = _build.libraries()["membw"].tc_membw_chunked
    n = MEMBW_N
    s = MEMBW_S
    props = torch.cuda.get_device_properties(0)
    turns = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = random_field(torch, (n,), dtype, seed=30)
        b = random_field(torch, (n,), dtype, seed=31)
        dst = torch.empty_like(x)
        xo, do = x[1:1 + n - 128], dst[1:1 + n - 128]
        library = {
            "copy": lambda: dst.copy_(x),
            "scale": lambda: torch.mul(x, s, out=dst),
            "add": lambda: torch.add(x, b, out=dst),
            "triad": lambda: torch.add(b, x, alpha=s, out=dst),
        }
        calls = {}
        for op, call in MEMBW_CALLS.items():
            calls[call] = library[op]
            calls[f"{membw_kernel_of(op, 'chunked')} {op}"] = (
                lambda op=op: membw.step_chunked(x, b, s, op, out=dst))
            calls[f"{membw_kernel_of(op, 'chunked')} {op} "
                  f"{CHUNKED_FIXED_ROWS} rows a CTA"] = (
                lambda op=op: membw.step_chunked(
                    x, b, s, op, CHUNKED_FIXED_ROWS, out=dst))
        # the copy's launch as step_chunked makes it, with no Python around
        # it: the wrapper's checks and argument packing are off the clock
        c_args = (x.data_ptr(), None, dst.data_ptr(), n,
                  KERNEL_DTYPE_CODES[dtype], membw.OP_CODES["copy"], float(s),
                  membw.default_chunk("chunked", dtype, "copy"),
                  torch.cuda.current_stream().cuda_stream)

        def c_copy(c_args=c_args):
            if c_entry(*c_args):
                fail("tc_membw_chunked refused the copy")
        dst.zero_()
        c_copy()
        if not torch.equal(dst.view(torch.uint8), x.view(torch.uint8)):
            fail(f"tc_membw_chunked's copy differs from x in {dtype}")
        calls["membw_unary copy, C entry"] = c_copy
        calls.update({
            "membw_stream": lambda: membw.step_stream(x, out=dst),
            "membw_dma": lambda: membw.step_dma(x, out=dst),
        })
        if dtype == torch.float32:
            stencil = mods[1].STEPS
            calls.update({
                "membw_stream scalar form (offset view, n - 128)":
                    lambda: membw.step_stream(xo, out=do),
                "membw_stream in place":
                    lambda: membw.step_stream(dst, out=dst, aliased=True),
                "jacobi1d_stream": lambda: stencil["stream"](
                    x, "dirichlet", out=dst),
                "jacobi1d_stream2": lambda: stencil["stream2"](
                    x, "dirichlet", out=dst),
            })
            for kib in CHUNKED_SWEEP_KIB:
                rows = kib * 1024 // (128 * x.element_size())
                for op in ("copy", "scale", "triad"):
                    calls[f"{membw_kernel_of(op, 'chunked')} {op} {kib} KiB "
                          "a CTA"] = (
                        lambda rows=rows, op=op: membw.step_chunked(
                            x, b, s, op, rows, out=dst))
            for kib in STREAM_SWEEP_KIB:
                rows = kib * 1024 // (128 * x.element_size())
                calls[f"membw_stream {kib} KiB a CTA"] = (
                    lambda rows=rows: membw.step_stream(x, rows, out=dst))
            for kib, depth in DMA_SWEEP:
                rows = kib * 1024 // (128 * x.element_size())
                if (depth * kib * 1024 + membw.DMA_BARRIER_BYTES
                        > props.shared_memory_per_block_optin):
                    continue
                calls[f"membw_dma {kib} KiB x {depth}"] = (
                    lambda rows=rows, depth=depth: membw.step_dma(
                        x, rows, depth, out=dst))
        name = str(dtype).removeprefix("torch.")
        t = turns[name] = in_turns(torch, calls)
        emit({"membw_turns": {
            "dtype": name, "shape": [n], "rounds": MEMBW_ROUNDS,
            "times": {label: {k: v[k] for k in ("ms", "spread_ms")}
                      for label, v in t.items()},
            "over_copy_": {label: v["ms"] / t["copy_"]["ms"]
                           for label, v in t.items()},
            "over_call": {
                f"{membw_kernel_of(op, 'chunked')} {op}": t[
                    f"{membw_kernel_of(op, 'chunked')} {op}"]["ms"]
                / t[call]["ms"] for op, call in MEMBW_CALLS.items()},
            "elapsed_s": time.perf_counter() - T0}})
        del x, b, dst, xo, do, calls, library
        torch.cuda.empty_cache()

    x = random_field(torch, (n,), torch.float32, seed=30)
    b = random_field(torch, (n,), torch.float32, seed=31)
    dst = torch.empty_like(x)
    library = {
        "copy": lambda: dst.copy_(x),
        "scale": lambda: torch.mul(x, s, out=dst),
        "add": lambda: torch.add(x, b, out=dst),
        "triad": lambda: torch.add(b, x, alpha=s, out=dst),
    }
    kernels = {
        "membw_stream": lambda: membw.step_stream(x, out=dst),
        "membw_dma": lambda: membw.step_dma(x, out=dst),
    }
    f32 = turns["float32"]
    out = {}
    for name, (_, ops, _) in MEMBW_KERNELS.items():
        for op in ops:
            label = name if name in kernels else f"{name} {op}"
            kernel = kernels.get(name) or (
                lambda op=op: membw.step_chunked(x, b, s, op, out=dst))
            got = kernel().clone()
            plain_ms = time_ms(
                torch, lambda: membw.step_plain(x, b, s, op, out=dst), 20)
            call = MEMBW_CALLS[op]
            lib_err = float((library[op]() - got).abs().max())
            nbytes = TRAFFIC[op] * n * x.element_size()
            ops_n = MEMBW_OPS_PER_ELEM[op] * n
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = ops_n / PEAK_F32_OPS_PER_S * 1e3
            kernel_ms = f32[label]["ms"]
            out[(name, op)] = {
                "kernel": name, "op": op, "shape": [n], "dtype": "float32",
                "kernel_ms": kernel_ms,
                "kernel_spread_ms": f32[label]["spread_ms"],
                "plain_ms": plain_ms,
                "library_ms": f32[call]["ms"],
                "library_spread_ms": f32[call]["spread_ms"],
                "library_call": call, "library_max_abs_err": lib_err,
                "copy_ms": f32["copy_"]["ms"],
                "bytes": nbytes, "ops": ops_n,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "gbps": nbytes / kernel_ms / 1e6,
            }
            emit({"times": {**out[(name, op)],
                            "elapsed_s": time.perf_counter() - T0}})
            del got
    del x, b, dst
    torch.cuda.empty_cache()
    return out


def family_modules() -> dict:
    """Stencil key -> the port's family module."""
    from tpu_comm_torch.kernels import kernels_for

    return {key: kernels_for(DIM[key], key if key in BOX else 0)
            for key in DIM}


def launch_counters(mods) -> dict:
    """Kernel name -> the wrapper whose ``launches`` counts its launches,
    for every kernel of the port."""
    from tpu_comm_torch.kernels import membw, pack

    counters = {
        KERNELS[arm][key][0]: mods[key].STEPS[arm]
        for arm in KERNELS for key in KERNELS[arm]
    }
    counters[PACK_KERNEL[0]] = pack.pack_faces
    counters.update({f"membw.{w.__name__}": w for w in membw.WRAPPERS})
    counters.update({MULTI_KERNELS[key][0]: mods[key].step_multi
                     for key in MULTI_KERNELS})
    counters.update({name: mods[key].step_wave_ghost
                     for key, (name, _) in GHOST_KERNELS.items()})
    return counters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script needs one GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpu_comm_torch.bench.timing import nvidia_smi_line
    from tpu_comm_torch.kernels import _build

    smi = nvidia_smi_line()
    if smi is None:
        fail("nvidia-smi gave no name and power limit")
    emit({"environment": {
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device_count": torch.cuda.device_count(),
        "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
    }})
    print(smi, flush=True)

    t0 = time.perf_counter()
    libs = _build.libraries()
    emit({"build": {"seconds": time.perf_counter() - t0,
                    "libraries": sorted(libs),
                    "build_dir": str(_build.BUILD_DIR.relative_to(ROOT))}})
    emit({"l2_fetch_granularity_bytes": l2_fetch_granularity(libs)})

    mods = family_modules()
    counters = launch_counters(mods)
    share_goldens()  # its host threads overlap phases 3 and 4
    errs = {arm: check_kernels(torch, mods, arm) for arm in KERNELS}
    ghost_errs = check_ghost_kernels(torch, mods)
    multi_errs = check_multi(torch, mods)
    pack_err = check_pack(torch)
    membw_errs = check_membw(torch)
    check_stream_loads(libs)
    check_chunked_access(libs)
    check_multi_spills(libs)
    launches = drive_main_path(torch, counters)
    multi_launches = drive_multi(torch, counters)
    membw_launches = drive_membw(torch, counters)
    tol_iters = {}
    mesh_launches = drive_mesh(torch, counters, tol_iters)
    drive_sweep(torch, counters)
    drive_profile(torch, counters)
    for name, n in drive_halo(torch, counters).items():
        mesh_launches[name] += n
    check_graph_replay(torch)
    check_graph_convergence(torch, tol_iters)
    drive_overlap(torch, counters)
    for name, n in drive_pack_bench(torch, counters).items():
        mesh_launches[name] += n
    drive_reshard(torch, counters)
    check_reshard_graph(torch)
    drive_attention(torch, counters)
    check_attention_graph(torch)
    times = {arm: measure_times(torch, mods, arm) for arm in KERNELS}
    multi_times = measure_multi(torch, mods)
    ghost_times = measure_ghost(torch, mods)
    pack_times = measure_pack(torch)
    measure_pack_spacing(torch)
    membw_times = measure_membw(torch, mods)
    measure_pack_steps(torch, mods)
    measure_dist_steps(torch, mods)
    measure_graph_turns(torch)

    print(smi, flush=True)
    stencil_rows = []
    for arm in KERNELS:
        for key in KERNELS[arm]:
            name, replaces = KERNELS[arm][key]
            t = times[arm][key]
            stencil_rows.append({
                "name": name, "route": "cuda",
                "source": (BOX_SOURCE if key in BOX and arm != "wave"
                           else SOURCES[arm]),
                "replaces": replaces,
                # the single-device runs plus the mesh runs that use it
                "launches": mesh_launches[name] + launches[name],
                "max_abs_err": errs[arm][key], "ms": t["kernel_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "copy_ms": t["copy_ms"],
                "chunked_copy_ms": t["chunked_copy_ms"],
                "shape": t["shape"], "dtype": "float32",
            })
    for key, (name, replaces) in GHOST_KERNELS.items():
        t = ghost_times[key]
        stencil_rows.append({
            "name": name, "route": "cuda", "source": SOURCES["wave"],
            "replaces": replaces, "launches": mesh_launches[name],
            "max_abs_err": ghost_errs[key], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "copy_ms": t["copy_ms"], "chunked_copy_ms": t["chunked_copy_ms"],
            "shape": t["shape"], "dtype": "float32",
        })
    for key, (name, replaces) in MULTI_KERNELS.items():
        t = multi_times[key]
        stencil_rows.append({
            "name": name, "route": "cuda", "source": MULTI_SOURCE,
            "replaces": replaces,
            # the single-device multi runs plus the 3D mesh wave runs
            "launches": multi_launches[name] + mesh_launches[name],
            "max_abs_err": multi_errs[key], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "spread_ms": t["kernel_spread_ms"],
            "copy_ms": t["copy_ms"], "chunked_copy_ms": t["chunked_copy_ms"],
            "t_steps": t["t_steps"], "shape": t["shape"], "dtype": "float32",
        })
    pack_row = {
        "name": PACK_KERNEL[0], "route": "cuda", "source": PACK_SOURCE,
        "replaces": PACK_KERNEL[1],
        "launches": mesh_launches[PACK_KERNEL[0]], "max_abs_err": pack_err,
        "ms": pack_times["kernel_ms"], "plain_ms": pack_times["plain_ms"],
        "bound_ms": pack_times["bound_ms"],
        "bound_by": pack_times["bound_by"],
        "library_ms": pack_times["library_ms"],
        "copy_ms": pack_times["copy_ms"], "call_ms": pack_times["call_ms"],
        "spread_ms": pack_times["kernel_spread_ms"],
        "cold_ms": pack_times["kernel_cold_ms"],
        "shape": pack_times["shape"], "dtype": "float32",
    }
    membw_rows = []
    for name, (replaces, _, op) in MEMBW_KERNELS.items():
        t = membw_times[(name, op)]
        membw_rows.append({
            "name": name, "route": "cuda", "source": MEMBW_SOURCE,
            "replaces": replaces, "launches": membw_launches[name],
            "max_abs_err": membw_errs[name], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "spread_ms": t["kernel_spread_ms"], "copy_ms": t["copy_ms"],
            "op": op, "shape": t["shape"], "dtype": "float32",
        })
    emit({"elapsed": {"seconds": time.perf_counter() - T0}})
    emit({"kernels": stencil_rows + [pack_row] + membw_rows})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
