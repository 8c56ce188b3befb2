"""A clock the port's tests control, for the rows' timed fields (no test
in here; jax-free, so the spawned ranks of the mesh tests import it).

The drivers time a loop by the slope between two loop lengths
(``tpu_comm_torch.bench.timing.time_loop_per_iter``), read off
``timing``'s ``time.perf_counter``. On a loaded machine the slope of so
short a loop can come out at or below zero; the driver then clamps it to
0.0 and writes the rates as null, and an assertion on a rate fails on
the machine's load. Under :func:`fake_clock` the clock is the test's:
each read advances it by ``read_s``, and each call of a timed loop's
``run_iters(k)`` adds ``k * per_iter_s``, paid at the next read. The
slope is then ``per_iter_s`` exactly (dyadic values: every sum is
exact), so a row's rate arithmetic can be asserted exactly.

The drivers bind ``time_loop_per_iter`` by name at import, so the clock
wraps it in each of them (:data:`TIMED_MODULES`, imported first).
"""

from __future__ import annotations

import contextlib
import importlib
import types

from tpu_comm_torch.bench import timing

#: seconds an iteration of a timed loop costs under the fake clock
PER_ITER_S = 2.0 ** -10
#: seconds a clock read costs (the fixed overhead of a timed call)
READ_S = 2.0 ** -7
#: the modules that time a loop with ``time_loop_per_iter``
TIMED_MODULES = (
    "tpu_comm_torch.bench.attention",
    "tpu_comm_torch.bench.halosweep",
    "tpu_comm_torch.bench.membw",
    "tpu_comm_torch.bench.packbench",
    "tpu_comm_torch.bench.reshard",
    "tpu_comm_torch.bench.stencil",
    "tpu_comm_torch.bench.sweep",
)


class FakeClock:
    """``perf_counter()`` of a clock that moves only as the test says."""

    def __init__(self, per_iter_s: float, read_s: float):
        self.per_iter_s, self.read_s = per_iter_s, read_s
        self.now = 0.0
        self.owed = 0.0

    def perf_counter(self) -> float:
        self.now += self.read_s + self.owed
        self.owed = 0.0
        return self.now


@contextlib.contextmanager
def fake_clock(per_iter_s: float = PER_ITER_S, read_s: float = READ_S):
    """Run the body with :class:`FakeClock` as the drivers' clock; yields
    the clock. ``per_iter_s`` may be 0 or negative (a lost slope)."""
    clock = FakeClock(per_iter_s, read_s)
    real = timing.time_loop_per_iter

    def counted(run_iters, iters, *args, **kwargs):
        def run(k):
            clock.owed += clock.per_iter_s * k
            return run_iters(k)

        return real(run, iters, *args, **kwargs)

    mods = [timing] + [importlib.import_module(m) for m in TIMED_MODULES]
    saved = [(timing, "time", timing.time)]
    timing.time = types.SimpleNamespace(perf_counter=clock.perf_counter)
    for mod in mods:
        if getattr(mod, "time_loop_per_iter", None) is real:
            saved.append((mod, "time_loop_per_iter", real))
            mod.time_loop_per_iter = counted
    try:
        yield clock
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
