"""Start the ranks of a mesh run and join their process group.

JAX runs one process over N devices; ``torch.distributed`` runs one
process per rank. Three ways into a group, all ending in the same
per-rank function (:func:`run_world` picks one):

- world size 1: the calling process creates a group of one (no child);
- ``RANK``/``WORLD_SIZE`` in the environment (``torchrun``): the process
  joins the group it is given (``env://``);
- otherwise :func:`run_ranks` spawns ``world`` children
  (``torch.multiprocessing``, ``spawn`` context) that rendezvous through a
  ``file://`` store in a fresh temporary directory, so concurrent runs
  never meet on a port.

Nothing here can wait for ever: the group carries a timeout, the parent
joins its children with a limit, and when one child dies the rest are
killed (a rank that raised leaves its neighbours in ``recv``).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

#: seconds a collective or a rendezvous may take, and a whole spawned run
DEFAULT_TIMEOUT_S = 600.0


def backend_for(device_type: str) -> str:
    """The ``torch.distributed`` backend for tensors on ``device_type``."""
    return "nccl" if device_type == "cuda" else "gloo"


def under_torchrun() -> bool:
    """Whether a launcher gave this process its place in a group."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


@contextlib.contextmanager
def process_group(
    backend: str, world: int = 1, rank: int = 0,
    init_method: str | None = None, timeout_s: float = DEFAULT_TIMEOUT_S,
):
    """The default process group for the body: the one already up (left
    up on exit), else a new one that is destroyed on exit. Without
    ``init_method`` a new group rendezvous through a ``file://`` store in
    a temporary directory of its own, which only a world of 1 can do."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"the process group has {dist.get_world_size()} ranks, "
                f"the mesh needs {world}"
            )
        yield
        return
    tmp = None
    if init_method is None:
        if world != 1:
            raise ValueError("a group of more than one rank needs an "
                             "init_method all ranks share")
        tmp = tempfile.mkdtemp(prefix="tpu_comm_torch_pg_")
        init_method = f"file://{tmp}/rendezvous"
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def barrier(device: torch.device) -> None:
    """Wait until every rank of the default group gets here (on a CUDA
    device, through a collective on that device)."""
    if device.type == "cuda":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()


def run_world(target, world: int, device: torch.device, args: tuple = (),
              timeout_s: float = DEFAULT_TIMEOUT_S, what: str = "the run"):
    """Run ``target(*args)`` on every rank of a world of ``world`` ranks
    in the default process group (NCCL for a CUDA ``device``, gloo for
    the CPU); returns rank 0's result, None on the other ranks where a
    launcher started this process as one of many.

    - ``RANK``/``WORLD_SIZE`` in the environment (``torchrun``): join the
      group the launcher gives, whose size must be ``world`` (else
      ValueError naming ``what``);
    - a world of one, or a group already up: run in this process;
    - otherwise :func:`run_ranks` spawns the ranks.
    """
    backend = backend_for(device.type)
    if under_torchrun() and not dist.is_initialized():
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(
                f"{what} needs {world} ranks, the launcher started "
                f"{os.environ['WORLD_SIZE']}"
            )
        if device.type == "cuda":
            torch.cuda.set_device(
                int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
            )
        with process_group(backend, world, int(os.environ["RANK"]),
                           "env://", timeout_s):
            return target(*args)
    if world == 1 or dist.is_initialized():
        with process_group(backend, world, timeout_s=timeout_s):
            return target(*args)
    return run_ranks(target, world, backend, args, timeout_s=timeout_s)


def _rank_main(rank, world, backend, use_cuda, run_dir, timeout_s, target,
               args):
    """Body of one spawned rank: join the group, run ``target(*args)``,
    leave the result (or the traceback) in ``run_dir``."""
    error = Path(run_dir) / f"error.{rank}.txt"

    def record_error():
        # the first record stands: leaving the group below closes this
        # rank's connections, and its peers' errors must come after its own
        if not error.exists():
            error.write_text(traceback.format_exc())

    try:
        if use_cuda:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        elif "OMP_NUM_THREADS" not in os.environ:
            # share the cores between the ranks unless the caller chose
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        with process_group(
            backend, world, rank, f"file://{run_dir}/rendezvous", timeout_s
        ):
            try:
                result = target(*args)
            except BaseException:
                record_error()
                raise
        with open(Path(run_dir) / f"result.{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        record_error()
        raise SystemExit(1)


def run_ranks(target, world: int, backend: str, args: tuple = (),
              timeout_s: float = DEFAULT_TIMEOUT_S):
    """Run ``target(*args)`` on ``world`` spawned ranks joined in one
    ``backend`` group; returns rank 0's result.

    ``target`` must be importable in a fresh interpreter (a module-level
    function). Raises RuntimeError naming the rank that failed first,
    with its error, or TimeoutError after ``timeout_s``; either way every
    child is dead on return.
    """
    import torch.multiprocessing as mp

    use_cuda = backend == "nccl"
    if use_cuda and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"a mesh of {world} ranks on the card needs {world} CUDA "
            f"devices, found {torch.cuda.device_count()} (NCCL refuses two "
            "ranks of one communicator on one device); run it with "
            "--backend cpu"
        )
    ctx = mp.get_context("spawn")
    run_dir = tempfile.mkdtemp(prefix="tpu_comm_torch_run_")
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(rank, world, backend, use_cuda, run_dir, timeout_s,
                  target, args),
            daemon=True,
        )
        for rank in range(world)
    ]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.exitcode for p in procs]
            if all(c == 0 for c in codes):
                break
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                # the ranks that raised for themselves write their error
                # before they exit; give the others a moment to do so
                time.sleep(0.2)
                raise RuntimeError(_failure_message(Path(run_dir), failed))
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world} ranks did not finish within {timeout_s:.0f} s"
                )
            time.sleep(0.02)
        with open(Path(run_dir) / "result.0.pkl", "rb") as f:
            return pickle.load(f)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(5)
        shutil.rmtree(run_dir, ignore_errors=True)


def _failure_message(run_dir: Path, failed: list[int]) -> str:
    """Name the rank that failed first (the oldest error file: the ranks
    it left waiting fail after it, with connection errors), with the last
    line of its traceback (the exception itself)."""
    errors = sorted(run_dir.glob("error.*.txt"),
                    key=lambda p: p.stat().st_mtime_ns)
    if not errors:
        return f"rank {failed[0]} died with no error (killed?)"
    rank = errors[0].name.split(".")[1]
    last = errors[0].read_text().strip().splitlines()[-1]
    return f"rank {rank} failed: {last}"
