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
- ``tune``    — the chunk autotuner (``bench/tune.py``): sweep a stencil
  family's chunked arms at a ladder of chunks, every row verified, and
  regenerate the tuned table (``tpu_comm_torch/data/tuned_chunks.json``)
  that the card consults where ``--chunk`` is left out and for
  ``--impl auto``. ``tune auto`` (JAX's closed-loop search) exits 2.
- ``report``  — JSONL rows as a markdown table (``bench/report.py``):
  ``--dedupe``, ``--best-chunks``, ``--emit-tuned TABLE``,
  ``--update-baseline FILE``.
- ``pipeline-gap`` — the pipeline-knob sweep (``bench/membw.py``): the
  chunked and stream copies with and without ``--aliased`` across a chunk
  ladder, and the 1D-3D stream stencils at every legal chunk.
- ``topo plan`` — the modelled-traffic mesh search (``comm/topoplan.py``):
  every factorisation of ``--n-devices`` scored against a declared mix of
  halo, reshard and collective arms; the winner is banked in
  ``tpu_comm_torch/data/topo_plan.json``, which a mesh built without a
  shape consults (``TPU_COMM_TOPO_PLAN``). Touches no device.
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


def _cmd_tune(args) -> int:
    from tpu_comm_torch.bench.tune import AUTO_NEEDS, TuneConfig, run_tune

    if args.mode == "auto":
        print(
            "error: tune auto (the closed-loop search) is not ported: it "
            f"needs {', '.join(AUTO_NEEDS)}, which ROADMAP queue A item 12 "
            "ports; run the ladder sweep, `tune` (sweep)", file=sys.stderr,
        )
        return 2
    # the sweep refuses the closed-loop search's flags, as JAX's does
    auto_only = [
        flag for flag, on in (
            ("--socket", bool(args.socket)),
            ("--serve-dir", bool(args.serve_dir)),
            ("--surface", bool(args.surface)),
            ("--journal", bool(args.journal)),
            ("--max-candidates", args.max_candidates is not None),
            ("--eta", args.eta is not None),
            ("--family", args.family != "membw"),
            ("--mesh", bool(args.mesh)),
            ("--bc", args.bc != "dirichlet"),
        ) if on
    ]
    if auto_only:
        verb = "belongs" if len(auto_only) == 1 else "belong"
        print(
            f"error: {'/'.join(auto_only)} {verb} to the closed-loop "
            "search (`tune auto`); the ladder sweep runs locally against "
            "the static candidate ladder", file=sys.stderr,
        )
        return 2
    try:
        chunks = tuple(_parse_ints(args.chunks, "--chunks") or ())
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg = TuneConfig(
        dim=args.dim, size=args.size, points=args.points, dtype=args.dtype,
        backend=args.backend,
        impls=tuple(args.impls.split(",")) if args.impls else (),
        chunks=chunks, iters=args.iters, warmup=args.warmup, reps=args.reps,
        verify_iters=args.verify_iters, jsonl=args.jsonl,
        **({} if args.table is None else {"table": args.table or None}),
        archives=args.archives,
        budget_seconds=args.budget_seconds,
        candidate_deadline_s=args.candidate_deadline,
    )
    try:
        summary = run_tune(cfg)
    except (ValueError, RuntimeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for row in summary["results"]:
        g = row["gbps_eff"]
        print(
            f"  {row['impl']:>8} chunk={row['chunk']:<6}"
            + (f" {g:8.2f} GB/s" if g else " below-resolution")
            + ("  verified" if row["verified"] else ""),
            file=sys.stderr,
        )
    for sk in summary["skipped"]:
        print(f"  {sk['impl']:>8} chunk={sk['chunk']:<6} skipped: "
              f"{sk['reason']}", file=sys.stderr)
    if summary["table_entries"] == 0:
        print(
            "notice: no rows qualified for the tuned table — it holds "
            "verified card rows with a resolved rate only (CPU timings, "
            "below-resolution rows and rows run at a tabled chunk never "
            "enter it)", file=sys.stderr,
        )
    print(json.dumps(summary, sort_keys=True))
    return 0


def _cmd_report(args) -> int:
    from tpu_comm_torch.bench.report import (
        best_chunks,
        dedupe_latest,
        emit_tuned,
        load_records,
        split_degraded,
        split_degraded_mesh,
        split_load,
        split_partial,
        to_markdown_table,
        update_baseline,
    )

    picked = [
        f for f, v in (
            ("--best-chunks", args.best_chunks),
            ("--update-baseline", args.update_baseline),
            ("--emit-tuned", args.emit_tuned),
        ) if v
    ]
    if len(picked) > 1:
        print(f"error: {' and '.join(picked)} are separate outputs; run "
              "them as separate invocations", file=sys.stderr)
        return 2
    try:
        records = load_records(args.results)
        for split, what in (
            (split_partial, "partial (fault-salvaged)"),
            (split_degraded, "degraded (verification fallback)"),
            (split_degraded_mesh, "degraded_mesh (reduced world size)"),
            (split_load, "load rung (serving)"),
        ):
            records, dropped = split(records)
            if dropped:
                print(f"notice: suppressed {len(dropped)} {what} row(s)",
                      file=sys.stderr)
        if args.dedupe:
            records = dedupe_latest(records)
        if args.emit_tuned:
            n = emit_tuned(records, args.emit_tuned)
            print(f"wrote {n} tuned-chunk entries to {args.emit_tuned}")
            return 0
        if args.best_chunks:
            for key, v in sorted(best_chunks(records).items(), key=str):
                wl, impl, dtype, platform, size, mesh = key
                when = f" [{v['date']}]" if v.get("date") else ""
                at_mesh = f", mesh={mesh}" if mesh is not None else ""
                print(f"{wl} ({impl}, {dtype}, {platform}, size={size}"
                      f"{at_mesh}): chunk={v['chunk']} -> {v['gbps_eff']} "
                      f"GB/s{when}")
            return 0
        if args.update_baseline:
            update_baseline(args.update_baseline, records)
            print(f"updated {args.update_baseline} with {len(records)} "
                  "records")
        else:
            print(to_markdown_table(records))
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


def _cmd_pipeline_gap(args) -> int:
    from tpu_comm_torch.bench.membw import (
        gap_config_from_cli,
        run_pipeline_gap,
    )

    try:
        cfg = gap_config_from_cli(
            args.dims, args.sizes, args.chunks, backend=args.backend,
            dtype=args.dtype, iters=args.iters, warmup=args.warmup,
            reps=args.reps, verify_iters=args.verify_iters, jsonl=args.jsonl,
            budget_seconds=args.budget_seconds,
        )
    except ValueError:
        print("error: --dims is a comma list of 1/2/3, --sizes a comma list "
              "of DIM=EDGE, --chunks a comma list of integers",
              file=sys.stderr)
        return 2
    try:
        summary = run_pipeline_gap(cfg)
    except (ValueError, RuntimeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for row in summary["results"]:
        g = row["gbps_eff"]
        knobs = ",".join(
            f"{k}={v}" for k, v in sorted(row["knobs"].items())
        ) or "defaults"
        print(
            f"  {row['workload']:>14} chunk={row['chunk']!s:<6} "
            f"{knobs:<14}"
            + (f" {g:8.2f} GB/s" if g else " below-resolution")
            + ("  verified" if row["verified"] else ""),
            file=sys.stderr,
        )
    for sk in summary["skipped"]:
        print(f"  {sk.get('kind')}/{sk.get('impl', 'stream')} "
              f"chunk={sk.get('chunk')!s} skipped: {sk['reason']}",
              file=sys.stderr)
    print(json.dumps(summary, sort_keys=True))
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


def _cmd_topo(args) -> int:
    """``topo plan``: search the mesh factorisations against a declared
    workload mix and bank the winner (no device touched)."""
    import datetime

    from tpu_comm_torch.comm import topoplan

    assert args.topo_cmd == "plan"
    try:
        arms = []
        for s in args.halo or ():
            arms.append(topoplan.parse_halo_spec(s))
        for s in args.reshard or ():
            arms.append(topoplan.parse_reshard_spec(s))
        for s in args.collective or ():
            arms.append(topoplan.parse_collective_spec(s))
        date = datetime.datetime.now(
            datetime.timezone.utc
        ).strftime("%Y-%m-%d")
        entry = topoplan.plan_entry(
            args.n_devices, args.ndims, arms, date=date,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(entry, sort_keys=True))
    else:
        red = entry["reduction_frac"]
        print(
            f"topo plan: {entry['n_devices']} devices, "
            f"{entry['ndims']}D, {len(entry['mix'])} arm(s), "
            f"{entry['feasible']}/{entry['candidates']} candidates "
            "feasible"
        )
        print(
            f"  winner  {tuple(entry['mesh'])}  "
            f"{entry['wire_per_step']:.0f} modeled wire B/step  "
            f"[plan {entry['plan_id']}]"
        )
        if entry["default_wire_per_step"] is not None:
            print(
                f"  default {tuple(entry['default_mesh'])}  "
                f"{entry['default_wire_per_step']:.0f} B/step  "
                f"({red * 100:.1f}% reduction)"
                if red is not None else
                f"  default {tuple(entry['default_mesh'])}  "
                f"{entry['default_wire_per_step']:.0f} B/step"
            )
        else:
            print(
                f"  default {tuple(entry['default_mesh'])} cannot "
                "host the mix"
            )
    if args.dry_run:
        return 0
    path = topoplan.save_plan(entry, path=args.out)
    print(f"banked plan {entry['plan_id']} -> {path}", file=sys.stderr)
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
        "collective sweep, reshard, attention and STREAM bandwidth "
        "drivers, and the topology planner",
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

    p_pg = sub.add_parser(
        "pipeline-gap",
        help="sweep the pipeline knobs {chunk, --aliased} over the chunked "
        "and stream copies and the 1D/2D/3D stream stencils at full size "
        "(rows bank knob-tagged; JAX's dimsem rows are dropped)",
    )
    _add_backend_arg(p_pg)
    p_pg.add_argument(
        "--dims", default="1,2,3",
        help="comma list of stream-stencil dims to sweep (the copy arms "
        "always run)",
    )
    p_pg.add_argument("--dtype", choices=["float32", "bfloat16"],
                      default="float32")
    p_pg.add_argument(
        "--sizes", default=None, metavar="DIM=EDGE,...",
        help="per-dim field-edge overrides (e.g. 1=4194304,2=1024); "
        "default 1D 2^26, 2D 8192, 3D 384",
    )
    p_pg.add_argument(
        "--chunks", default=None,
        help="comma list of chunk candidates over the shared ladder "
        "(kernels/tiling.py CHUNK_LADDER; rows of 128 for the copies and "
        "1D, strip rows in 2D, planes in 3D)",
    )
    p_pg.add_argument("--iters", type=int, default=30)
    p_pg.add_argument("--warmup", type=int, default=2)
    p_pg.add_argument("--reps", type=int, default=3)
    p_pg.add_argument(
        "--verify-iters", type=int, default=50,
        help="steps each stencil row's verification holds against the "
        "golden (the stencil's --verify-iters)",
    )
    p_pg.add_argument("--jsonl", default="results/pipeline_gap.jsonl")
    p_pg.add_argument(
        "--budget-seconds", type=float, default=None,
        help="wall-clock cap, checked between rows: the rows left are "
        "recorded as skipped",
    )
    p_pg.set_defaults(func=_cmd_pipeline_gap)

    p_tn = sub.add_parser(
        "tune",
        help="chunk autotuner: sweep the chunked arms' chunk candidates "
        "on the device (every row verified), bank the rows and regenerate "
        "the tuned table the card consults where --chunk is left out",
    )
    _add_backend_arg(p_tn)
    p_tn.add_argument(
        "mode", nargs="?", choices=["sweep", "auto"], default="sweep",
        help="sweep (default): walk the chunk ladder for one stencil "
        "family; auto: JAX's closed-loop search, not ported (exits 2)",
    )
    p_tn.add_argument("--dim", type=int, choices=[1, 2, 3], default=1)
    p_tn.add_argument(
        "--size", type=int, default=None,
        help="global points per dimension (default 2^26 / 8192 / 384 for "
        "--dim 1 / 2 / 3)",
    )
    p_tn.add_argument("--dtype", choices=["float32", "bfloat16", "float16"],
                      default="float32")
    p_tn.add_argument(
        "--points", type=int, choices=[9, 27], default=0,
        help="tune a box stencil's stream arm instead of the star (9: "
        "--dim 2, banked as stencil2d-9pt; 27: --dim 3, stencil3d-27pt)",
    )
    p_tn.add_argument(
        "--impls", default=None,
        help="comma list of chunked arms, of grid, stream, stream2 "
        "(default: stream, and stream2 in 1D)",
    )
    p_tn.add_argument(
        "--chunks", default=None,
        help="comma list of chunk candidates (default: the ladder of the "
        "dim; rows of 128 cells in 1D, strip rows in 2D, planes in 3D)",
    )
    p_tn.add_argument("--iters", type=int, default=50)
    p_tn.add_argument("--warmup", type=int, default=2)
    p_tn.add_argument("--reps", type=int, default=3)
    p_tn.add_argument(
        "--verify-iters", type=int, default=50,
        help="steps each row's verification holds against the golden (the "
        "stencil's --verify-iters)",
    )
    p_tn.add_argument("--jsonl", default="results/tune.jsonl")
    p_tn.add_argument(
        "--table", default=None,
        help="tuned-table path to regenerate (default: the table the "
        "lookups read, tpu_comm_torch/data/tuned_chunks.json in the "
        "package; empty string disables)",
    )
    p_tn.add_argument(
        "--archives", default="bench_archive/**/*.jsonl",
        help="more row sources for the table's regeneration (only rows "
        "measured on the card enter it)",
    )
    p_tn.add_argument(
        "--budget-seconds", type=float, default=None,
        help="wall-clock cap on the sweep: the candidates left are "
        "recorded as skipped and the table regenerates from what banked",
    )
    p_tn.add_argument(
        "--candidate-deadline", type=float, default=None, metavar="SECS",
        help="a candidate's cap: on the CPU abandoned and skipped; on the "
        "card the sweep ends there",
    )
    for flag, kw in (
        ("--max-candidates", {"type": int}), ("--eta", {"type": int}),
        ("--socket", {}), ("--serve-dir", {}), ("--journal", {}),
        ("--surface", {}), ("--mesh", {}),
    ):
        p_tn.add_argument(flag, default=None,
                          help="tune auto only (not ported)", **kw)
    p_tn.add_argument("--family", choices=["membw", "stencil"],
                      default="membw", help="tune auto only (not ported)")
    p_tn.add_argument("--bc", choices=["dirichlet", "periodic"],
                      default="dirichlet", help="tune auto only (not ported)")
    p_tn.set_defaults(func=_cmd_tune)

    p_rp = sub.add_parser(
        "report",
        help="render JSONL rows as a markdown table, regenerate a "
        "BASELINE-style '## Measured' section or the tuned table",
    )
    p_rp.add_argument("results", nargs="+",
                      help="JSONL result files (globs ok)")
    p_rp.add_argument(
        "--update-baseline", default=None, metavar="BASELINE.md",
        help="rewrite this file's '## Measured' section in place",
    )
    p_rp.add_argument(
        "--dedupe", action="store_true",
        help="keep only the newest record per measurement configuration",
    )
    p_rp.add_argument(
        "--best-chunks", action="store_true",
        help="the fastest chunk per (workload, impl, dtype, platform, "
        "size)",
    )
    p_rp.add_argument(
        "--emit-tuned", default=None, metavar="TUNED.json",
        help="regenerate the tuned table from verified card rows",
    )
    p_rp.set_defaults(func=_cmd_report)

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

    p_tp = sub.add_parser(
        "topo",
        help="mesh placement tools: `topo plan` searches every "
        "factorization of N devices against a declared workload mix "
        "(halo/reshard/collective arms) with the wire-edge models and "
        "banks the winner in tpu_comm_torch/data/topo_plan.json "
        "(consulted by a mesh built without a shape, through "
        "TPU_COMM_TOPO_PLAN)",
    )
    tp_sub = p_tp.add_subparsers(dest="topo_cmd", required=True)
    p_tpp = tp_sub.add_parser(
        "plan",
        help="search factorizations and bank the modeled-wire winner "
        "(no device touched)",
    )
    p_tpp.add_argument("--n-devices", type=int, required=True,
                       help="device count the plan answers for")
    p_tpp.add_argument("--ndims", type=int, choices=[1, 2, 3],
                       default=2, help="mesh rank (default 2)")
    p_tpp.add_argument(
        "--halo", action="append", metavar="SPEC", default=None,
        help="halo arm GSHAPE[:wN][:pN][:fN][:periodic][:DTYPE][:xW] "
        "(e.g. 6144x768:w2:periodic:x200); repeatable",
    )
    p_tpp.add_argument(
        "--reshard", action="append", metavar="SPEC", default=None,
        help="reshard arm GSHAPE:toMESH[:naive|sequential][:DTYPE]"
        "[:xW] (candidate mesh is the source; scored fwd+rev); "
        "repeatable",
    )
    p_tpp.add_argument(
        "--collective", action="append", metavar="SPEC", default=None,
        help="collective arm OP:NBYTES[:axisN][:xW] with OP one of "
        "ppermute/allreduce-ring/allgather-ring/bcast-tree; "
        "repeatable",
    )
    p_tpp.add_argument(
        "--out", default=None,
        help="artifact path to upsert (default: the banked "
        "tpu_comm_torch/data/topo_plan.json)",
    )
    p_tpp.add_argument("--dry-run", action="store_true",
                       help="print the winner, bank nothing")
    p_tpp.add_argument("--json", action="store_true",
                       help="print the full entry as one JSON line")
    p_tp.set_defaults(func=_cmd_topo)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)
