"""``stencil --profile DIR``: a ``torch.profiler`` trace of the timed loop
(port of ``tpu_comm/bench/stencil.py`` ``_maybe_profile``, which writes a
``jax.profiler`` trace of the same regions).

Each rank writes one Chrome trace, ``DIR/rank<r>.json`` (open it in
Perfetto or ``chrome://tracing``), and no other file: CPU activities
always, and on the card CUDA activities (CUPTI), whose kernel, copy and
memset events carry the device time. A trace of a card run that holds no
device event (CUPTI did not load, or recorded nothing) is an error and
is not kept: such a trace would read as a run that did no device work.
"""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass
from pathlib import Path

#: Chrome-trace categories of the events that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass(frozen=True)
class Event:
    """One complete event of a Chrome trace: name, category, start and
    duration in microseconds."""

    name: str
    cat: str
    ts: float
    dur: float

    @property
    def end(self) -> float:
        return self.ts + self.dur


def read_events(path) -> list[Event]:
    """The complete (``ph: X``) events of the Chrome trace at ``path``."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [Event(e["name"], e.get("cat", ""), float(e.get("ts", 0.0)),
                  float(e.get("dur", 0.0)))
            for e in events if e.get("ph") == "X"]


def trace_ops(path, categories=DEVICE_CATEGORIES
              ) -> dict[str, tuple[int, float]]:
    """``name -> (count, total microseconds)`` of the complete events of
    ``categories`` (default: the device's) in the Chrome trace at
    ``path``. A host event's time includes the events it encloses."""
    ops: dict[str, tuple[int, float]] = {}
    for e in read_events(path):
        if e.cat in categories:
            count, total = ops.get(e.name, (0, 0.0))
            ops[e.name] = (count + 1, total + e.dur)
    return ops


@contextlib.contextmanager
def maybe_profile(profile_dir: str | None, device):
    """Trace the body into ``profile_dir/rank<r>.json`` when
    ``profile_dir`` is set (``r``: this process's rank in the default
    group, 0 without one); a no-op otherwise. Raises RuntimeError, and
    leaves no trace of this rank, when a trace of a CUDA ``device``
    holds no device event."""
    if not profile_dir:
        yield
        return
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    rank = dist.get_rank() if dist.is_initialized() else 0
    path = Path(profile_dir) / f"rank{rank}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    # a failed run must not leave an earlier run's trace looking like its own
    path.unlink(missing_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    partial = path.with_name(f".{path.name}.partial")
    try:
        prof.export_chrome_trace(str(partial))
        if device.type == "cuda" and not trace_ops(partial):
            raise RuntimeError(
                "--profile: the trace of the card holds no kernel, copy or "
                "memset event (CUPTI did not load or recorded nothing); no "
                "trace was written"
            )
        os.replace(partial, path)
    finally:
        partial.unlink(missing_ok=True)
