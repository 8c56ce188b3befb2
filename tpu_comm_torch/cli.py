"""Command line of the port: ``python -m tpu_comm_torch <subcommand>``.

- ``stencil`` — the single-device 1D/2D/3D Jacobi driver
  (``bench/stencil.py``), with the JAX CLI's flag names for what it has.
- ``info``    — torch and CUDA versions and the device a backend gives.

Flags of the JAX CLI that this slice does not port (``--mesh``,
``--points``, ``--fuse-steps``, ``--halo-*``, ``--dimsem``, ...) are not
accepted. Errors print ``error: ...`` and exit 2.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_backend_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--backend", choices=["cuda", "cpu"], default="cuda",
        help="device: the CUDA card (default; an error where there is "
        "none) or the CPU, which runs the kernels' plain PyTorch versions",
    )


def _cmd_stencil(args) -> int:
    from tpu_comm_torch.bench.stencil import (
        DEFAULT_SIZES,
        StencilConfig,
        run_single_device,
    )

    try:
        record = run_single_device(StencilConfig(
            dim=args.dim,
            size=args.size if args.size else DEFAULT_SIZES[args.dim],
            iters=args.iters,
            dtype=args.dtype,
            bc=args.bc,
            impl=args.impl,
            chunk=args.chunk,
            backend=args.backend,
            verify=args.verify,
            verify_iters=args.verify_iters,
            tol=args.tol,
            check_every=args.check_every,
            warmup=args.warmup,
            reps=args.reps,
            jsonl=args.jsonl,
            load=args.load,
            dump=args.dump,
        ))
    except (ValueError, RuntimeError, OSError) as e:
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
        description="PyTorch/CUDA port of tpu_comm's stencil driver",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_info = sub.add_parser("info", help="torch/CUDA versions and device")
    _add_backend_arg(p_info)
    p_info.set_defaults(func=_cmd_info)

    p_st = sub.add_parser(
        "stencil", help="Jacobi stencil benchmark (1D/2D/3D, one device)"
    )
    _add_backend_arg(p_st)
    p_st.add_argument("--dim", type=int, choices=[1, 2, 3], default=1)
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
        help="rows per CUDA block (1D: rows of 128 elements; 2D: rows of "
        "a 32-column strip) or z-planes per block (3D); default: the "
        "kernel's own. Sets the launch grid, never the result",
    )
    p_st.add_argument(
        "--dtype", choices=["float32", "bfloat16", "float16"],
        default="float32",
    )
    p_st.add_argument(
        "--bc", choices=["dirichlet", "periodic"], default="dirichlet"
    )
    p_st.add_argument(
        "--impl", default="auto",
        help="local update: 'auto' (default) or 'stream' (the hand-written "
        "CUDA kernel; its plain PyTorch version on the CPU). The JAX "
        "package's other arms are not yet ported (see ROADMAP.md)",
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
        "--load", default=None, metavar="NPY",
        help="start from this .npy field instead of the default init",
    )
    p_st.add_argument(
        "--dump", default=None, metavar="NPY",
        help="write the post-run field to this .npy (bfloat16 as float32)",
    )
    p_st.set_defaults(func=_cmd_stencil)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)
