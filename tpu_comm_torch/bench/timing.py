"""Timing and result rows (port of ``tpu_comm/bench/timing.py``).

PyTorch returns before the card finishes, so every timed call ends in
``torch.cuda.synchronize()`` before the host clock is read. Per-iteration
time is a slope between two loop lengths, so fixed costs (launch of the
first kernel, the final synchronise, the input copy) cancel. Rows are
plain JSON lines stamped with ``date``, ``ts`` and a small ``prov``.
"""

from __future__ import annotations

import datetime
import json
import os
import statistics
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

#: cap on the raw per-rep samples a row carries (``t_reps_s``)
RAW_REPS_CAP = 32
_REPO = Path(__file__).resolve().parents[2]


@dataclass
class Timing:
    """Per-repetition wall-clock seconds for one timed region, plus its
    per-phase seconds (``warmup_s`` and ``timed_s``)."""

    times: list[float] = field(default_factory=list)
    phases: dict[str, float] = field(default_factory=dict)

    @property
    def median(self) -> float:
        return statistics.median(self.times)

    def summary(self) -> dict:
        if not self.times:
            raise ValueError(
                "Timing.summary() needs at least one timed repetition; "
                "none were recorded"
            )
        if len(self.times) >= 2:
            deciles = statistics.quantiles(
                self.times, n=10, method="inclusive"
            )
            p10, p90 = deciles[0], deciles[-1]
            stddev = statistics.stdev(self.times)
        else:
            p10 = p90 = self.times[0]
            stddev = 0.0
        return {
            "reps": len(self.times),
            "median_s": self.median,
            "mean_s": statistics.fmean(self.times),
            "min_s": min(self.times),
            "max_s": max(self.times),
            "p10_s": p10,
            "p90_s": p90,
            "stddev_s": stddev,
            "reps_s": [round(x, 9) for x in self.times[:RAW_REPS_CAP]],
        }

    def phase_fields(self) -> dict:
        """``{"phases": {...}}`` for a row, or ``{}`` if none recorded."""
        return {"phases": dict(self.phases)} if self.phases else {}


def sync(x):
    """Wait until the card has finished the work that produced ``x``."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


def time_fn(fn, warmup: int = 3, reps: int = 10, barrier=None) -> Timing:
    """Time ``fn()`` (returning a tensor), synchronised after each call.
    ``warmup`` calls are untimed; all ``reps`` samples are kept. On a
    mesh, ``barrier`` (called before every clock read, after the
    synchronise) lines the ranks up, so a rep times the slowest rank."""
    if reps < 1 or warmup < 0:
        raise ValueError(
            f"need reps >= 1 and warmup >= 0, got {reps=} {warmup=}"
        )

    def clock() -> float:
        if barrier is not None:
            barrier()
        return time.perf_counter()

    t0 = clock()
    for _ in range(warmup):
        sync(fn())
    t = Timing(phases={"warmup_s": clock() - t0})
    t0 = d1 = clock()
    for _ in range(reps):
        d0 = d1
        sync(fn())
        d1 = clock()
        t.times.append(d1 - d0)
    t.phases["timed_s"] = d1 - t0
    return t


def time_loop_per_iter(
    run_iters, iters: int, warmup: int = 2, reps: int = 5, ratio: int = 3,
    barrier=None,
) -> tuple[float, Timing, Timing]:
    """Per-iteration seconds of a loop, free of fixed overhead: the slope
    ``(t(ratio*iters) - t(iters)) / ((ratio-1)*iters)`` of the medians.
    Returns ``(secs_per_iter, timing_lo, timing_hi)``; ``timing_lo``'s
    phases are the sum of both runs'. ``barrier`` as in :func:`time_fn`."""
    lo, hi = iters, ratio * iters
    t_lo = time_fn(lambda: run_iters(lo), warmup=warmup, reps=reps,
                   barrier=barrier)
    t_hi = time_fn(lambda: run_iters(hi), warmup=warmup, reps=reps,
                   barrier=barrier)
    per_iter = (t_hi.median - t_lo.median) / (hi - lo)
    t_lo.phases = {
        k: t_lo.phases.get(k, 0.0) + t_hi.phases.get(k, 0.0)
        for k in {*t_lo.phases, *t_hi.phases}
    }
    return max(per_iter, 0.0), t_lo, t_hi


def _run_quiet(cmd: list[str]) -> str | None:
    """One line of a tool's output, or None where the tool is missing or
    fails."""
    try:
        res = subprocess.run(
            cmd, capture_output=True, text=True, timeout=20, cwd=_REPO,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if res.returncode != 0 or not res.stdout.strip():
        return None
    return res.stdout.strip().splitlines()[0]


def nvidia_smi_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return _run_quiet([
        "nvidia-smi", "--query-gpu=name,power.limit",
        "--format=csv,noheader",
    ])


def provenance() -> dict:
    """What produced a row: torch and CUDA versions, the card's name and
    power limit, and the checkout's git commit (None where unknown)."""
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "nvidia_smi": nvidia_smi_line() if cuda else None,
        "git": _run_quiet(["git", "rev-parse", "HEAD"]),
    }


def emit_jsonl(record: dict, path: str | None = None) -> str:
    """Stamp ``record`` with ``date``, ``ts`` and ``prov``, append it to
    ``path`` as one JSON line when given, and return the line."""
    record = dict(record)
    now = datetime.datetime.now(datetime.timezone.utc)
    record.setdefault("date", now.strftime("%Y-%m-%d"))
    record.setdefault("ts", now.strftime("%Y-%m-%dT%H:%M:%S.%fZ"))
    record.setdefault("prov", provenance())
    line = json.dumps(record, sort_keys=True)
    if path:
        fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, (line + "\n").encode())
        finally:
            os.close(fd)
    return line
