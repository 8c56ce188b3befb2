"""Command line of the port: ``python -m tpu_comm_torch <subcommand>``.

- ``stencil`` — the 1D/2D/3D Jacobi driver (``bench/stencil.py``), the
  star stencils or with ``--points 9|27`` the box stencils, on one device
  or with ``--mesh`` across a Cartesian mesh of ranks with ghost-cell
  halo exchange; the JAX CLI's flag names for what it has, the port's own
  arm names (``bench/__init__.py`` maps them).
  A mesh run takes the JAX CLI's shaping axes: ``--halo-wire`` (narrow
  ghosts), ``--impl partitioned --halo-parts K`` (sub-slab transfers),
  ``--halo-width K`` (the deep-halo window), and ``--fuse-steps N`` /
  ``--fuse-sweep N,...`` (N-step dispatches, each a CUDA graph replay
  on the card).
- ``halo``    — the halo-exchange bandwidth sweep (``bench/halosweep.py``):
  halo-exchange GB/s per rank over a 1/2/3-D mesh, by block size.
- ``halosweep`` — the deep-halo crossover sweep: one stencil row per
  ``--halo-width`` and the fit of the crossover model.
- ``sweep``   — the collective bandwidth sweep (``bench/sweep.py``) over
  ``torch.distributed``, one rank a device, with the JAX CLI's flags and
  op names.
- ``reshard`` — the array-redistribution benchmark (``bench/reshard.py``):
  naive all-gather against the sequential point-to-point decomposition,
  over the union world of two mesh factorizations.
- ``attention`` — ring and Ulysses sequence-parallel attention
  (``bench/attention.py``) over a 1D ring of ranks.
- ``membw``   — the STREAM bandwidth quartet (``bench/membw.py``), with the
  JAX CLI's flags; its arms carry the port's names (``bench/__init__.py``
  maps them).
- ``overlap`` — C9 verification (``bench/overlap.py``): the exchange's P2P
  ops a step and, on the card, the compute that ran while an NCCL kernel
  did, read off a ``torch.profiler`` trace; ``--fuse-steps N`` audits a
  fused dispatch (one graph launch holding the exchanges).
- ``pack``    — the face-pack microbenchmark (``bench/packbench.py``): the
  face-pack kernel against slice copies of the faces, one row an arm.
- ``info``    — torch and CUDA versions and the device a backend gives.

Flags of the JAX CLI that the port does not have (``--dimsem`` of
``stencil``, the obs and resilience flags, ...) are not accepted;
``membw --dimsem``, ``pack --chunk|--dimsem`` and ``overlap --topology``
are refused with their reasons. Errors print ``error: ...`` and exit 2.
"""

from __future__ import annotations

import argparse
import json
import sys

from tpu_comm_torch.bench import MEMBW_OPS, RESHARD_IMPLS, SWEEP_OPS


def _add_backend_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--backend", choices=["cuda", "cpu"], default="cuda",
        help="device: the CUDA card (default; an error where there is "
        "none) or the CPU, which runs the kernels' plain PyTorch versions",
    )


def _parse_mesh(text: str) -> tuple[int, ...]:
    try:
        return tuple(int(part) for part in text.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh takes comma-separated integers (e.g. 2,2), got {text!r}"
        ) from None


def _parse_ints(text: str | None, flag: str) -> list[int] | None:
    if text is None:
        return None
    try:
        return [int(x) for x in text.split(",") if x]
    except ValueError:
        raise ValueError(
            f"{flag} must be a comma list of integers, got {text!r}"
        ) from None


def _fuse_values(args) -> list:
    """The --fuse-steps value of each row: one row, or one per
    --fuse-sweep value, every value checked before the first row runs
    (the JAX CLI's rules and messages)."""
    if args.fuse_sweep is not None and args.fuse_steps is not None:
        raise ValueError(
            "--fuse-sweep and --fuse-steps are exclusive (the sweep "
            "IS the steps-per-dispatch axis)"
        )
    values = _parse_ints(args.fuse_sweep, "--fuse-sweep")
    if values is None:
        return [args.fuse_steps]
    if not values:
        raise ValueError("--fuse-sweep is empty")
    for v in values:
        if v < 1:
            raise ValueError(f"--fuse-sweep values must be >= 1, got {v}")
        if args.iters % v != 0:
            raise ValueError(
                f"--iters ({args.iters}) must be a multiple of "
                f"every --fuse-sweep value (got {v})"
            )
        if args.halo_width is not None and (
            args.halo_width > v or v % args.halo_width != 0
        ):
            raise ValueError(
                f"--halo-width ({args.halo_width}) does not "
                f"tile the --fuse-sweep value {v} into whole "
                f"exchange-free windows"
            )
    return values


def _cmd_stencil(args) -> int:
    from tpu_comm_torch.bench import JAX_STENCIL_PACKS
    from tpu_comm_torch.bench.stencil import (
        DEFAULT_SIZES,
        StencilConfig,
        run_distributed_bench,
        run_single_device,
    )

    if args.pack in JAX_STENCIL_PACKS:
        print(f"error: --pack {args.pack} is the JAX package's name; the "
              f"port calls it {JAX_STENCIL_PACKS[args.pack]!r}",
              file=sys.stderr)
        return 2
    run = run_single_device if args.mesh is None else run_distributed_bench
    try:
        for fuse in _fuse_values(args):
            record = run(StencilConfig(
                dim=args.dim,
                points=args.points,
                size=args.size if args.size else DEFAULT_SIZES[args.dim],
                iters=args.iters,
                dtype=args.dtype,
                bc=args.bc,
                impl=args.impl,
                chunk=args.chunk,
                t_steps=args.t_steps,
                mesh=args.mesh,
                pack=args.pack,
                halo_wire=args.halo_wire,
                halo_parts=args.halo_parts,
                halo_width=args.halo_width,
                fuse_steps=fuse,
                dist_timeout=args.dist_timeout,
                backend=args.backend,
                verify=args.verify,
                verify_iters=args.verify_iters,
                tol=args.tol,
                check_every=args.check_every,
                warmup=args.warmup,
                reps=args.reps,
                jsonl=args.jsonl,
                profile=args.profile,
                load=args.load,
                dump=args.dump,
            ))
            # under a launcher every rank runs this; rank 0 alone has
            # the row
            if record is not None:
                print(json.dumps(record, sort_keys=True), flush=True)
    except (ValueError, RuntimeError, OSError, TimeoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


def _cmd_halo(args) -> int:
    from tpu_comm_torch.bench.halosweep import (
        HaloSweepConfig,
        run_halo_sweep,
    )

    try:
        records = run_halo_sweep(HaloSweepConfig(
            dim=args.dim,
            backend=args.backend,
            mesh=args.mesh,
            dtype=args.dtype,
            width=args.width,
            halo_wire=args.halo_wire,
            min_bytes=args.min_bytes,
            max_bytes=args.max_bytes,
            iters=args.iters,
            warmup=args.warmup,
            reps=args.reps,
            periodic=not args.open_edges,
            verify=not args.no_verify,
            jsonl=args.jsonl,
            dist_timeout=args.dist_timeout,
        ))
    except (ValueError, RuntimeError, AssertionError, OSError,
            TimeoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for r in records or ():
        print(json.dumps(r, sort_keys=True))
    return 0


def _cmd_halosweep(args) -> int:
    from tpu_comm_torch.bench.halosweep import (
        DeepHaloSweepConfig,
        run_deep_halo_sweep,
    )

    try:
        widths = _parse_ints(args.widths, "--widths") or []
        out = run_deep_halo_sweep(DeepHaloSweepConfig(
            dim=args.dim,
            size=args.size,
            mesh=args.mesh,
            widths=tuple(widths),
            impl=args.impl,
            bc=args.bc,
            dtype=args.dtype,
            iters=args.iters,
            fuse_steps=args.fuse_steps,
            halo_wire=args.halo_wire,
            backend=args.backend,
            verify=not args.no_verify,
            warmup=args.warmup,
            reps=args.reps,
            jsonl=args.jsonl,
            dist_timeout=args.dist_timeout,
        ))
    except (ValueError, RuntimeError, AssertionError, OSError,
            TimeoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if out is None:  # a rank other than 0 under a launcher
        return 0
    records, summary = out
    for r in records:
        print(json.dumps(r, sort_keys=True))
    model = summary.get("crossover_model")
    if model:
        print(
            f"crossover: measured best k={summary['measured_best_width']}"
            f", modeled best k={model['modeled_best_width']} "
            f"(per-cell {model['per_cell_s']:.3g}s, per-msg "
            f"{model['per_msg_s']:.3g}s)",
            file=sys.stderr,
        )
    print(json.dumps(summary, sort_keys=True))
    return 0


def _cmd_sweep(args) -> int:
    from tpu_comm_torch.bench.sweep import SweepConfig, run_sweep

    cfg = SweepConfig(
        op=args.op,
        backend=args.backend,
        n_devices=args.n_devices,
        dtype=args.dtype,
        wire_dtype=args.wire_dtype,
        acc_dtype=args.acc_dtype,
        min_bytes=args.min_bytes,
        max_bytes=args.max_bytes,
        iters=args.iters,
        warmup=args.warmup,
        reps=args.reps,
        verify=not args.no_verify,
        jsonl=args.jsonl,
        dist_timeout=args.dist_timeout,
    )
    try:
        records = run_sweep(cfg)
    except (ValueError, RuntimeError, AssertionError, OSError,
            TimeoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # under a launcher every rank runs this; rank 0 alone has the rows
    for r in records or ():
        print(json.dumps(r, sort_keys=True))
    return 0


def _cmd_reshard(args) -> int:
    from tpu_comm_torch.bench.reshard import ReshardConfig, run_reshard_bench

    try:
        src_mesh = _parse_ints(args.src_mesh, "--src-mesh")
        dst_mesh = _parse_ints(args.dst_mesh, "--dst-mesh")
        if not src_mesh or not dst_mesh:
            raise ValueError("--src-mesh and --dst-mesh must be non-empty")
        records = run_reshard_bench(ReshardConfig(
            src_mesh=tuple(src_mesh), dst_mesh=tuple(dst_mesh),
            size=args.size, dtype=args.dtype, impl=args.impl,
            backend=args.backend, iters=args.iters, warmup=args.warmup,
            reps=args.reps, verify=not args.no_verify, jsonl=args.jsonl,
        ))
    except (ValueError, RuntimeError, AssertionError, OSError,
            TimeoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # under a launcher every rank runs this; rank 0 alone has the rows
    for r in records or ():
        print(json.dumps(r, sort_keys=True))
    return 0


def _cmd_attention(args) -> int:
    from tpu_comm_torch.bench.attention import AttnConfig, run_attention_bench

    try:
        record = run_attention_bench(AttnConfig(
            seq=args.seq, heads=args.heads, head_dim=args.head_dim,
            impl=args.impl, causal=args.causal, dtype=args.dtype,
            backend=args.backend, n_devices=args.n_devices,
            iters=args.iters, warmup=args.warmup, reps=args.reps,
            verify=not args.no_verify, jsonl=args.jsonl,
        ))
    except (ValueError, RuntimeError, AssertionError, OSError,
            TimeoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if record is not None:  # rank 0
        print(json.dumps(record, sort_keys=True))
    return 0


def _cmd_membw(args) -> int:
    from tpu_comm_torch.bench.membw import (
        MembwConfig,
        config_for_arm,
        run_membw,
    )

    if args.dimsem is not None:
        print("error: --dimsem sets Mosaic's grid semantics on the TPU and "
              "has no counterpart here: CUDA blocks are always unordered",
              file=sys.stderr)
        return 2
    cfg = MembwConfig(
        op=args.op, impl=args.impl, backend=args.backend, size=args.size,
        dtype=args.dtype, chunk=args.chunk, aliased=args.aliased,
        depth=args.depth, iters=args.iters, warmup=args.warmup,
        reps=args.reps, verify=not args.no_verify, jsonl=args.jsonl,
    )
    # chunked first for "both": its checks (size, chunk) then fail before
    # the torch arm has measured and written a row
    impls = ["chunked", "torch"] if args.impl == "both" else [args.impl]
    for impl in impls:
        arm = config_for_arm(cfg, impl) if args.impl == "both" else cfg
        try:
            record = run_membw(arm)
        except (ValueError, RuntimeError, AssertionError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(json.dumps(record, sort_keys=True))
    return 0


def _mesh_spec(spec: str | None, dim: int) -> tuple[int, ...] | None:
    """A ``--mesh`` comma list checked against ``--dim`` (the JAX CLI's
    ``_parse_mesh``, with its messages); None for no spec."""
    if not spec:
        return None
    mesh = tuple(_parse_ints(spec, "--mesh"))
    if len(mesh) != dim:
        raise ValueError(
            f"--mesh must have {dim} comma-separated entries for --dim "
            f"{dim}, got {spec!r}"
        )
    return mesh


def _cmd_overlap(args) -> int:
    from tpu_comm_torch.bench.overlap import OverlapConfig, run_overlap

    if args.topology:
        print("error: --topology compiles for a TPU topology ahead of time "
              "and has no counterpart here: the port reads its overlap "
              "evidence off a trace of the cards it runs on",
              file=sys.stderr)
        return 2
    try:
        doc = run_overlap(OverlapConfig(
            dim=args.dim, size=args.size,
            mesh=_mesh_spec(args.mesh, args.dim), bc=args.bc,
            impl=args.impl, fuse_steps=args.fuse_steps,
            halo_parts=args.halo_parts, halo_width=args.halo_width,
            backend=args.backend, dist_timeout=args.dist_timeout,
        ))
    except (ValueError, NotImplementedError, RuntimeError, OSError,
            TimeoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if doc is not None:  # rank 0
        print(json.dumps(doc, sort_keys=True))
    return 0


def _cmd_pack(args) -> int:
    from tpu_comm_torch.bench.packbench import (
        JAX_PACK_IMPLS,
        PackConfig,
        run_pack_bench,
    )

    if args.chunk is not None or args.dimsem is not None:
        print("error: --chunk and --dimsem set the Pallas pack kernel's "
              "y-block and grid semantics on the TPU; the port's kernel "
              "takes its grid from pack_plan (warps striding over the "
              "faces), so neither has a counterpart here", file=sys.stderr)
        return 2
    if args.impl in JAX_PACK_IMPLS:
        print(f"error: --impl {args.impl} is the JAX package's name; the "
              f"port calls this arm {JAX_PACK_IMPLS[args.impl]!r}",
              file=sys.stderr)
        return 2
    impls = ["fused", "kernel"] if args.impl == "both" else [args.impl]
    for impl in impls:
        try:
            record = run_pack_bench(PackConfig(
                nz=args.nz, ny=args.ny, nx=args.nx, impl=impl,
                backend=args.backend, dtype=args.dtype, iters=args.iters,
                warmup=args.warmup, reps=args.reps,
                verify=not args.no_verify, jsonl=args.jsonl,
            ))
        except (ValueError, RuntimeError, AssertionError, OSError) as e:
            # an arm that fails after another has printed its row leaves
            # that row standing
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(json.dumps(record, sort_keys=True))
    return 0


def _cmd_info(args) -> int:
    import torch

    from tpu_comm_torch.topo import get_device

    try:
        device = get_device(args.backend)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    info = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": str(device),
    }
    if device.type == "cuda":
        info["name"] = torch.cuda.get_device_name(device)
        info["count"] = torch.cuda.device_count()
    print(json.dumps(info, sort_keys=True))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_comm_torch",
        description="PyTorch/CUDA port of tpu_comm: the stencil, halo, "
        "collective sweep, reshard, attention and STREAM bandwidth drivers",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_info = sub.add_parser("info", help="torch/CUDA versions and device")
    _add_backend_arg(p_info)
    p_info.set_defaults(func=_cmd_info)

    p_st = sub.add_parser(
        "stencil",
        help="Jacobi stencil benchmark (1D/2D/3D), on one device or "
        "across a rank mesh with halo exchange",
    )
    _add_backend_arg(p_st)
    p_st.add_argument("--dim", type=int, choices=[1, 2, 3], default=1)
    p_st.add_argument(
        "--mesh", type=_parse_mesh, default=None, metavar="P[,Q[,R]]",
        help="ranks per axis of a Cartesian mesh (as many axes as --dim), "
        "one process each: the grid is decomposed over it and every step "
        "exchanges ghost cells. Without RANK/WORLD_SIZE in the environment "
        "the command starts its own ranks (none for a mesh of 1); under "
        "torchrun it joins the group it is given. The card needs one GPU "
        "per rank",
    )
    p_st.add_argument(
        "--pack", default="fused",
        help="ghost pack of a 3D mesh run with --impl overlap, block or "
        "stream: 'fused' (slice copies, default) or 'kernel' (the "
        "hand-written face-pack kernel; JAX 'pallas')",
    )
    p_st.add_argument(
        "--dist-timeout", type=float, default=600.0, metavar="SECONDS",
        help="limit for a collective, the rendezvous and the whole run of "
        "the ranks a mesh run starts; when one rank fails the rest are "
        "killed and the command exits non-zero",
    )
    p_st.add_argument(
        "--size", type=int, default=None,
        help="global points per dimension (default: 2^20 for 1D, 4096 for "
        "2D, 256 for 3D)",
    )
    p_st.add_argument("--iters", type=int, default=100)
    p_st.add_argument(
        "--tol", type=float, default=None,
        help="convergence mode: iterate until the per-step L2 residual "
        "reaches TOL, checked every --check-every steps; --iters becomes "
        "the max-iterations cap",
    )
    p_st.add_argument(
        "--check-every", type=int, default=10,
        help="residual-check period in iterations for --tol mode",
    )
    p_st.add_argument(
        "--chunk", type=int, default=None,
        help="the launch grid of a chunked arm (stream, stream2, grid, "
        "wave, multi): rows per CUDA block (1D: rows of 128 elements; 2D: "
        "rows of the stream kernel's 32-column strip, of the grid "
        "kernel's 256-column tile, of a wave ring block of a 256-column "
        "strip, or of the 64-column multi tile) or z-planes per block "
        "(3D stream); not taken by the 3D wave and multi arms (they "
        "stream one plane a step); default: the kernel's own. Sets the "
        "launch grid, never the result",
    )
    p_st.add_argument(
        "--t-steps", type=int, default=8,
        help="iterations fused per HBM pass for --impl multi; "
        "--iters must be a multiple",
    )
    p_st.add_argument(
        "--dtype", choices=["float32", "bfloat16", "float16"],
        default="float32",
    )
    p_st.add_argument(
        "--bc", choices=["dirichlet", "periodic"], default="dirichlet"
    )
    p_st.add_argument(
        "--points", type=int, choices=[9, 27], default=0,
        help="stencil shape: omit for the per-dim star (3/5/7-point); "
        "9 = the 2D box stencil (--dim 2; reads corner neighbors), "
        "27 = the 3D box stencil (--dim 3; reads edge AND corner "
        "neighbors). On a mesh, the workloads that consume the transitive "
        "corner ghosts. Arms: 'stream', 'block', 'wave' and 'torch' on "
        "one device, and 'multi' for --points 9; 'torch', 'overlap', "
        "'block', 'stream', 'multi' and 'wave' on a mesh",
    )
    p_st.add_argument(
        "--impl", default="auto",
        help="local update. One device: 'stream' (the chunked CUDA kernel; "
        "JAX 'pallas-stream'; what 'auto' picks), 'block' (the "
        "whole-field CUDA kernel; JAX 'pallas'), 'torch' (plain PyTorch in "
        "the field's dtype, no kernel; JAX 'lax'), 'grid' (a window a CUDA "
        "block, 1D and 2D; JAX 'pallas-grid'), 'wave' (ring-buffered block "
        "streams, 1D, 2D and --points 9|27, dirichlet only; JAX "
        "'pallas-wave'), "
        "'stream2' (the stream kernel's column-strip carry form, 1D; JAX "
        "'pallas-stream2') or 'multi' (--t-steps steps a pass by temporal "
        "blocking, 1D, 2D, --points 9 and 3D, the 3D wavefront dirichlet "
        "only; JAX 'pallas-multi'). With --mesh "
        "'block', 'stream', 'torch' (plain PyTorch on the ghost-padded "
        "block), 'overlap' (interior/boundary split in plain PyTorch; what "
        "'auto' picks there), 'multi' (one width-t ghost exchange, then "
        "t steps in plain PyTorch), 'wave' (every stencil and bc: 1D "
        "and 2D the ghost-fed wave kernel after the exchange, 3D the "
        "wavefront at t = 1 and the boxes their wave kernels during it) and "
        "'partitioned' (the overlap split with each face sent as "
        "--halo-parts sub-slab transfers, the star stencils). "
        "On the CPU a kernel arm runs its plain PyTorch version",
    )
    p_st.add_argument(
        "--fuse-steps", type=int, default=None, metavar="N",
        help="steps per dispatch (mesh only): run the timed loop as "
        "chains of N-step dispatches; on the card each is one replay of a "
        "CUDA graph of the N steps, exchanges included, captured once, "
        "over buffers reused in place (on the CPU N eager steps); N=1 is "
        "the per-step-dispatch baseline; --iters must be a multiple",
    )
    p_st.add_argument(
        "--fuse-sweep", default=None, metavar="N,N,...",
        help="steps-per-dispatch sweep: one row per listed --fuse-steps "
        "value, every value checked first; exclusive with --fuse-steps",
    )
    p_st.add_argument(
        "--halo-parts", type=int, default=None, metavar="K",
        help="sub-slabs per face for --impl partitioned: each face splits "
        "into K sub-slabs along its largest other axis, each its own "
        "transfer sliced from the raw block; default 2",
    )
    p_st.add_argument(
        "--halo-width", type=int, default=None, metavar="K",
        help="communication-avoiding deep halo (mesh, the star stencils, "
        "--impl torch|overlap): exchange a width-K ghost zone ONCE per K "
        "steps (chained, corners included), then run K exchange-free "
        "steps that shrink the valid region by one cell a side, "
        "recomputing the redundant boundary cells; --iters (and "
        "--fuse-steps) must be K multiples; K=1 equals --impl torch",
    )
    p_st.add_argument(
        "--halo-wire", choices=["bfloat16", "float16"], default=None,
        help="send the ghosts in this narrower dtype, widened on receipt "
        "(mesh only): half the wire bytes of a float32 field; --verify "
        "then allows the wire's rounding, once a step",
    )
    p_st.add_argument(
        "--verify", action="store_true",
        help="check against the serial NumPy golden before timing",
    )
    p_st.add_argument(
        "--verify-iters", type=int, default=50,
        help="iterations the --verify check runs",
    )
    p_st.add_argument("--warmup", type=int, default=3)
    p_st.add_argument("--reps", type=int, default=10)
    p_st.add_argument(
        "--jsonl", default=None, help="append the result row to this file"
    )
    p_st.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler trace of the timed loop to "
        "DIR/rank<r>.json, one Chrome trace a rank (CPU activities, and "
        "CUDA kernels on the card; open in Perfetto); a card trace with "
        "no kernel event is an error and is not kept",
    )
    p_st.add_argument(
        "--load", default=None, metavar="NPY",
        help="start from this .npy field instead of the default init",
    )
    p_st.add_argument(
        "--dump", default=None, metavar="NPY",
        help="write the post-run field to this .npy (bfloat16 as float32)",
    )
    p_st.set_defaults(func=_cmd_stencil)

    p_ha = sub.add_parser(
        "halo",
        help="halo-exchange bandwidth sweep (halo-exchange GB/s per rank) "
        "over a 1/2/3-D mesh of ranks, by block size",
    )
    _add_backend_arg(p_ha)
    p_ha.add_argument("--dim", type=int, choices=[1, 2, 3], default=3)
    p_ha.add_argument(
        "--mesh", type=_parse_mesh, default=None, metavar="P[,Q[,R]]",
        help="ranks per axis (as many axes as --dim), one process and one "
        "device each; default: a near-square factoring of the world (the "
        "launcher's, else every CUDA device, else 1 on the CPU)",
    )
    p_ha.add_argument(
        "--dtype", choices=["float32", "bfloat16", "float16"],
        default="float32",
    )
    p_ha.add_argument(
        "--width", type=int, default=1,
        help="halo width in cells (deeper stencils exchange wider slabs)",
    )
    p_ha.add_argument(
        "--halo-wire", choices=["bfloat16", "float16"], default=None,
        help="exchange the ghosts in this narrower dtype (widened on "
        "receipt): half the wire bytes of a float32 field; the verify "
        "oracle rounds its slabs the same way",
    )
    p_ha.add_argument("--min-bytes", type=int, default=1 << 14,
                      help="smallest block a rank (bytes)")
    p_ha.add_argument("--max-bytes", type=int, default=1 << 26,
                      help="largest block a rank (bytes)")
    p_ha.add_argument("--iters", type=int, default=20)
    p_ha.add_argument("--warmup", type=int, default=2)
    p_ha.add_argument("--reps", type=int, default=5)
    p_ha.add_argument(
        "--open-edges", action="store_true",
        help="non-periodic mesh: the global edges receive zeros instead "
        "of wrapping",
    )
    p_ha.add_argument("--no-verify", action="store_true")
    p_ha.add_argument("--jsonl", default=None)
    p_ha.add_argument(
        "--dist-timeout", type=float, default=600.0, metavar="SECONDS",
        help="limit for a collective, the rendezvous and the whole run of "
        "the ranks the command starts",
    )
    p_ha.set_defaults(func=_cmd_halo)

    p_hs = sub.add_parser(
        "halosweep",
        help="deep-halo crossover sweep: one mesh stencil row per "
        "--halo-width of --widths, then the fit of the per-cell and "
        "per-message cost model",
    )
    _add_backend_arg(p_hs)
    p_hs.add_argument("--dim", type=int, choices=[1, 2, 3], default=2)
    p_hs.add_argument(
        "--size", type=int, default=None,
        help="global points per dimension (the stencil's default per dim)",
    )
    p_hs.add_argument(
        "--mesh", type=_parse_mesh, required=True, metavar="P[,Q[,R]]",
        help="ranks per axis (required: the crossover is a distributed "
        "measurement)",
    )
    p_hs.add_argument(
        "--widths", default=None, metavar="K,K,...",
        help="halo widths to sweep (default 1,2,4,8); --iters must be a "
        "multiple of every value",
    )
    p_hs.add_argument(
        "--impl", choices=["auto", "torch", "overlap"], default="auto",
        help="the arms the deep window composes with (auto: overlap)",
    )
    p_hs.add_argument(
        "--bc", choices=["dirichlet", "periodic"], default="dirichlet",
    )
    p_hs.add_argument(
        "--dtype", choices=["float32", "bfloat16", "float16"],
        default="float32",
    )
    p_hs.add_argument("--iters", type=int, default=64)
    p_hs.add_argument(
        "--fuse-steps", type=int, default=None, metavar="N",
        help="run every width as N-step dispatches (CUDA graph replays "
        "on the card; N a multiple of every width)",
    )
    p_hs.add_argument(
        "--halo-wire", choices=["bfloat16", "float16"], default=None,
        help="narrow wire dtype of the deep exchange (see stencil)",
    )
    p_hs.add_argument("--no-verify", action="store_true")
    p_hs.add_argument("--warmup", type=int, default=2)
    p_hs.add_argument("--reps", type=int, default=3)
    p_hs.add_argument("--jsonl", default=None)
    p_hs.add_argument(
        "--dist-timeout", type=float, default=600.0, metavar="SECONDS",
        help="limit for a collective, the rendezvous and the whole run of "
        "the ranks the command starts",
    )
    p_hs.set_defaults(func=_cmd_halosweep)

    p_sw = sub.add_parser(
        "sweep", help="collective bandwidth sweep (allreduce/bcast/rs-ag/...)"
    )
    _add_backend_arg(p_sw)
    p_sw.add_argument("--op", choices=list(SWEEP_OPS), default="allreduce")
    p_sw.add_argument(
        "--n-devices", type=int, default=None,
        help="ranks, one process and one device each (default: the "
        "launcher's world, else every CUDA device on the card, else 1 on "
        "the CPU); without RANK/WORLD_SIZE in the environment the command "
        "starts its own ranks",
    )
    p_sw.add_argument(
        "--dtype", choices=["float32", "bfloat16", "float16"],
        default="float32",
    )
    p_sw.add_argument(
        "--wire-dtype", choices=["bfloat16", "float16"], default=None,
        help="explicit-ring wire dtype (mixed-precision arm)",
    )
    p_sw.add_argument(
        "--acc-dtype", choices=["float32"], default=None,
        help="explicit-ring accumulation dtype",
    )
    p_sw.add_argument("--min-bytes", type=int, default=1 << 10)
    p_sw.add_argument(
        "--max-bytes", type=int, default=1 << 26,
        help="largest per-rank buffer (bytes); default 64 MiB, pass "
        "1073741824 (1 GiB) on the card for the full BASELINE.json:8 "
        "envelope",
    )
    p_sw.add_argument("--iters", type=int, default=20)
    p_sw.add_argument("--warmup", type=int, default=2)
    p_sw.add_argument("--reps", type=int, default=5)
    p_sw.add_argument("--no-verify", action="store_true")
    p_sw.add_argument("--jsonl", default=None)
    p_sw.add_argument(
        "--dist-timeout", type=float, default=600.0, metavar="SECONDS",
        help="limit for a collective, the rendezvous and the whole run of "
        "the ranks the command starts; when one rank fails the rest are "
        "killed and the command exits non-zero",
    )
    p_sw.set_defaults(func=_cmd_sweep)

    p_rs = sub.add_parser(
        "reshard",
        help="mesh->mesh array-redistribution benchmark: naive "
        "all-gather then re-slice against the sequential point-to-point "
        "decomposition, with modeled bytes, a bitwise NumPy oracle and "
        "peak live memory next to GB/s",
    )
    _add_backend_arg(p_rs)
    p_rs.add_argument(
        "--src-mesh", required=True, metavar="A,B,...",
        help="source mesh factorization, comma-separated (size-1 axes for "
        "lower-dim meshes, e.g. 8,1); the global array must divide by "
        "every axis",
    )
    p_rs.add_argument(
        "--dst-mesh", required=True, metavar="A,B,...",
        help="destination mesh factorization, as many axes as --src-mesh; "
        "the rank counts may differ (the run spans the union world, one "
        "rank a device: on the card as many GPUs)",
    )
    p_rs.add_argument(
        "--size", type=int, default=None,
        help="global points per dimension (default: 2^20 for 1-axis "
        "meshes, 1024 for 2, 128 for 3); must divide by both meshes' "
        "axis sizes",
    )
    p_rs.add_argument(
        "--dtype", choices=["float32", "bfloat16", "float16"],
        default="float32",
    )
    p_rs.add_argument(
        "--impl", choices=list(RESHARD_IMPLS), default="both",
        help="redistribution arm; 'both' (default) measures naive then "
        "sequential",
    )
    p_rs.add_argument("--iters", type=int, default=10,
                      help="round trips (src->dst->src) per timed run; "
                      "one iteration is two reshards")
    p_rs.add_argument("--warmup", type=int, default=2)
    p_rs.add_argument("--reps", type=int, default=5)
    p_rs.add_argument("--no-verify", action="store_true")
    p_rs.add_argument("--jsonl", default=None)
    p_rs.set_defaults(func=_cmd_reshard)

    p_at = sub.add_parser(
        "attention",
        help="long-context sequence-parallel attention benchmark (ring "
        "point-to-point pipeline / Ulysses all-to-all)",
    )
    _add_backend_arg(p_at)
    p_at.add_argument("--seq", type=int, default=4096)
    p_at.add_argument("--heads", type=int, default=8)
    p_at.add_argument("--head-dim", type=int, default=128)
    p_at.add_argument("--impl", choices=["ring", "ulysses"], default="ring")
    p_at.add_argument("--causal", action="store_true")
    p_at.add_argument("--dtype", choices=["float32", "bfloat16"],
                      default="float32")
    p_at.add_argument(
        "--n-devices", type=int, default=None,
        help="ranks, one process and one device each (default: the "
        "launcher's world, else every CUDA device on the card, else 1 on "
        "the CPU); without RANK/WORLD_SIZE in the environment the command "
        "starts its own ranks",
    )
    p_at.add_argument("--iters", type=int, default=10)
    p_at.add_argument("--warmup", type=int, default=2)
    p_at.add_argument("--reps", type=int, default=5)
    p_at.add_argument("--no-verify", action="store_true")
    p_at.add_argument("--jsonl", default=None)
    p_at.set_defaults(func=_cmd_attention)

    p_mb = sub.add_parser(
        "membw",
        help="STREAM bandwidth quartet (copy/scale/add/triad): the copy "
        "kernels and the measured roofline denominator",
    )
    _add_backend_arg(p_mb)
    p_mb.add_argument("--op", choices=list(MEMBW_OPS), default="triad")
    p_mb.add_argument(
        "--impl", default="both",
        help="arms: 'torch' (one PyTorch op per pass; JAX 'lax'), 'chunked' "
        "(the CUDA kernels; JAX 'pallas'), 'stream' (the 1D stencil kernel "
        "with the arithmetic removed, --op copy only; JAX 'pallas-stream'), "
        "'dma' (the copy pipelined by hand through shared memory, --op copy "
        "only; JAX 'pallas-dma'); 'both' = chunked + torch (default)",
    )
    p_mb.add_argument(
        "--size", type=int, default=1 << 26,
        help="elements (default 2^26 = 256 MiB per float32 array); a "
        "multiple of 128 for the kernel arms",
    )
    p_mb.add_argument(
        "--dtype", choices=["float32", "bfloat16", "float16"],
        default="float32",
    )
    p_mb.add_argument(
        "--chunk", type=int, default=None,
        help="rows of 128 elements per CUDA block (chunked, stream) or per "
        "ring slot (dma); default: the kernel's own. Sets the launch grid, "
        "never the result",
    )
    p_mb.add_argument(
        "--aliased", action="store_true",
        help="write each pass into its input (the JAX input_output_aliases "
        "knob); chunked and stream arms",
    )
    p_mb.add_argument(
        "--depth", type=int, default=None, metavar="K",
        help="shared-memory ring slots of --impl dma (default 2)",
    )
    p_mb.add_argument(
        "--dimsem", default=None,
        help="not available: Mosaic grid semantics have no counterpart on "
        "the GPU (refused)",
    )
    p_mb.add_argument("--iters", type=int, default=50)
    p_mb.add_argument("--warmup", type=int, default=2)
    p_mb.add_argument("--reps", type=int, default=5)
    p_mb.add_argument("--no-verify", action="store_true")
    p_mb.add_argument(
        "--jsonl", default=None, help="append the result rows to this file"
    )
    p_mb.set_defaults(func=_cmd_membw)

    p_ov = sub.add_parser(
        "overlap",
        help="run the distributed step and report C9 overlap evidence "
        "from a trace (P2P ops a step; on the card the compute that ran "
        "while an NCCL kernel did)",
    )
    _add_backend_arg(p_ov)
    p_ov.add_argument("--dim", type=int, choices=[1, 2, 3], default=3)
    p_ov.add_argument("--size", type=int, default=None,
                      help="global points per dimension (default 64, "
                      "rounded down to the mesh)")
    p_ov.add_argument("--mesh", default=None,
                      help="ranks per axis (default: the world, factored)")
    p_ov.add_argument("--bc", choices=["dirichlet", "periodic"],
                      default="dirichlet")
    p_ov.add_argument(
        "--impl", default="overlap",
        help="'torch' (exchange, then the stencil on the padded block; "
        "JAX 'lax'), 'overlap' (interior update while the exchange is in "
        "flight, default) or 'partitioned' (the same, faces sent as "
        "sub-slabs)",
    )
    p_ov.add_argument(
        "--fuse-steps", type=int, default=None, metavar="N",
        help="audit the fused N-step dispatch instead: on the card one "
        "graph launch whose replay holds the exchanges' NCCL kernels, no "
        "host P2P call or synchronisation between steps",
    )
    p_ov.add_argument("--halo-parts", type=int, default=None, metavar="K",
                      help="sub-slabs per face for --impl partitioned")
    p_ov.add_argument(
        "--halo-width", type=int, default=None, metavar="K",
        help="with --fuse-steps: audit the deep-halo window and prove one "
        "exchange round a K-step window",
    )
    p_ov.add_argument(
        "--topology", default=None, metavar="NAME",
        help="not available: ahead-of-time compilation for a TPU topology "
        "has no counterpart on the GPU (refused)",
    )
    p_ov.add_argument(
        "--dist-timeout", type=float, default=600.0, metavar="S",
        help="seconds the ranks the command starts may take",
    )
    p_ov.set_defaults(func=_cmd_overlap)

    p_pk = sub.add_parser(
        "pack",
        help="face-pack microbenchmark: the face-pack kernel vs slice "
        "copies of the faces over a 3D block",
    )
    _add_backend_arg(p_pk)
    p_pk.add_argument("--nz", type=int, default=128)
    p_pk.add_argument("--ny", type=int, default=128)
    p_pk.add_argument("--nx", type=int, default=512)
    p_pk.add_argument(
        "--impl", default="both",
        help="'fused' (slice copies; JAX 'lax'), 'kernel' (the face-pack "
        "kernel; JAX 'pallas') or 'both' (one row an arm, default)",
    )
    p_pk.add_argument("--dtype", choices=["float32", "bfloat16"],
                      default="float32")
    p_pk.add_argument("--chunk", type=int, default=None,
                      help="not available: the Pallas kernel's y-block "
                      "(refused)")
    p_pk.add_argument("--dimsem", default=None,
                      help="not available: Mosaic grid semantics (refused)")
    p_pk.add_argument("--iters", type=int, default=20)
    p_pk.add_argument("--warmup", type=int, default=2)
    p_pk.add_argument("--reps", type=int, default=5)
    p_pk.add_argument("--no-verify", action="store_true")
    p_pk.add_argument("--jsonl", default=None)
    p_pk.set_defaults(func=_cmd_pack)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)
