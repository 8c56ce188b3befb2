"""The port's slope timing under a clock the test controls
(``torch_fake_clock``): ``time_loop_per_iter`` reads the slope the clock
was given and clamps a non-positive one to 0.0, and a driver whose slope
is lost writes its rates as null with ``below_timing_resolution`` set,
as the JAX drivers do. No assertion here reads the machine's clock."""

import pytest

from tpu_comm_torch.bench import membw as pmembw
from tpu_comm_torch.bench import packbench as ppack
from tpu_comm_torch.bench import stencil as pstencil
from tpu_comm_torch.bench import timing
from torch_fake_clock import PER_ITER_S, READ_S, fake_clock

SLOPES = {"positive": PER_ITER_S, "zero": 0.0, "negative": -PER_ITER_S}


@pytest.mark.parametrize("slope", list(SLOPES.values()), ids=list(SLOPES))
@pytest.mark.parametrize("iters,ratio", [(4, 3), (7, 2)])
def test_time_loop_per_iter_reads_the_slope_and_clamps_it(slope, iters,
                                                          ratio):
    calls = []
    with fake_clock(per_iter_s=slope):
        per_iter, lo, hi = timing.time_loop_per_iter(
            calls.append, iters, warmup=2, reps=3, ratio=ratio)
    assert per_iter == max(slope, 0.0)
    # every rep is one clock read plus its loop's iterations
    assert lo.times == [READ_S + slope * iters] * 3
    assert hi.times == [READ_S + slope * ratio * iters] * 3
    assert calls == [iters] * 5 + [ratio * iters] * 5
    assert set(lo.phases) == {"warmup_s", "timed_s"}


def test_time_fn_times_one_clock_read_a_rep_outside_a_loop():
    with fake_clock():
        t = timing.time_fn(lambda: None, warmup=1, reps=4)
    assert t.times == [READ_S] * 4 and t.median == READ_S


def _membw(**kw):
    return pmembw.run_membw(pmembw.MembwConfig(
        backend="cpu", size=4 * 8 * 128, iters=2, warmup=1, reps=1, **kw))


def _stencil(**kw):
    return pstencil.run_single_device(pstencil.StencilConfig(
        backend="cpu", dim=1, size=4096, iters=4, warmup=1, reps=1, **kw))


def _pack(**kw):
    return ppack.run_pack_bench(ppack.PackConfig(
        backend="cpu", nz=4, ny=6, nx=8, iters=2, warmup=1, reps=1, **kw))


DRIVERS = {
    "membw-torch": (lambda: _membw(op="scale", impl="torch"),
                    ("gbps_eff",)),
    "membw-chunked": (lambda: _membw(op="triad", impl="chunked"),
                      ("gbps_eff",)),
    "stencil": (lambda: _stencil(), ("gbps_eff", "iters_per_s")),
    "pack-fused": (lambda: _pack(impl="fused"), ("gbps_eff", "gbps_faces")),
    "pack-kernel": (lambda: _pack(impl="kernel"),
                    ("gbps_eff", "gbps_faces")),
}


@pytest.mark.parametrize("slope", [0.0, -PER_ITER_S], ids=["zero",
                                                         "negative"])
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_a_lost_slope_writes_null_rates(driver, slope):
    run, rates = DRIVERS[driver]
    with fake_clock(per_iter_s=slope):
        row = run()
    assert row["secs_per_iter"] == 0.0
    assert row["below_timing_resolution"] is True
    assert all(row[r] is None for r in rates)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_a_kept_slope_writes_its_rates(driver):
    run, rates = DRIVERS[driver]
    with fake_clock():
        row = run()
    assert row["secs_per_iter"] == PER_ITER_S
    assert row["below_timing_resolution"] is False
    assert all(isinstance(row[r], float) and row[r] > 0 for r in rates)


def test_the_clock_is_given_back():
    real = (timing.time, timing.time_loop_per_iter,
            pmembw.time_loop_per_iter, pstencil.time_loop_per_iter,
            ppack.time_loop_per_iter)
    with fake_clock():
        assert timing.time is not real[0]
        assert pstencil.time_loop_per_iter is not real[3]
    assert (timing.time, timing.time_loop_per_iter,
            pmembw.time_loop_per_iter, pstencil.time_loop_per_iter,
            ppack.time_loop_per_iter) == real
