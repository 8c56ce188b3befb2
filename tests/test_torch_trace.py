"""``stencil --profile DIR`` on the CPU: a ``torch.profiler`` trace of
the timed loop, one Chrome trace a rank (``DIR/rank<r>.json``) and no
other file, the row unchanged; and the refusal of a card trace with no
device event (``tpu_comm_torch/bench/trace.py``).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_comm_torch.bench import stencil as pstencil
from tpu_comm_torch.bench import trace

ROOT = Path(__file__).resolve().parents[1]
#: fields a row carries whatever the run measured
IDENTITY = ("workload", "impl", "backend", "platform", "mesh", "bc",
            "dtype", "size", "iters", "verified")


def _ops(path) -> dict:
    """cpu_op name -> count of the Chrome trace at ``path``."""
    return {name: c for name, (c, _) in
            trace.trace_ops(path, ("cpu_op",)).items()}


@pytest.mark.parametrize("extra", [
    dict(impl="block", iters=4),
    dict(impl="torch", iters=50, tol=0.5, check_every=5),
], ids=["slope", "tol"])
def test_single_device_profile_writes_one_trace_and_the_same_row(tmp_path,
                                                                 extra):
    common = dict(dim=2, size=64, backend="cpu", warmup=1, reps=2,
                  verify=True, verify_iters=2, **extra)
    plain = pstencil.run_single_device(pstencil.StencilConfig(**common))
    row = pstencil.run_single_device(pstencil.StencilConfig(
        profile=str(tmp_path / "prof"), **common))
    assert sorted(row) == sorted(plain)
    assert {k: row[k] for k in IDENTITY} == {k: plain[k] for k in IDENTITY}
    assert [p.name for p in (tmp_path / "prof").iterdir()] == ["rank0.json"]
    ops = _ops(tmp_path / "prof" / "rank0.json")
    # the steps' arithmetic ran inside the traced region
    assert ops.get("aten::add", 0) >= common["reps"]
    assert trace.trace_ops(tmp_path / "prof" / "rank0.json") == {}


def test_mesh_profile_writes_a_trace_a_rank_with_the_exchange(tmp_path):
    prof = tmp_path / "prof"
    argv = [sys.executable, "-m", "tpu_comm_torch", "stencil", "--backend",
            "cpu", "--dim", "2", "--size", "64", "--mesh", "2,2", "--impl",
            "block", "--bc", "periodic", "--iters", "2", "--warmup", "1",
            "--reps", "1", "--verify", "--verify-iters", "2",
            "--dist-timeout", "120"]
    runs = [subprocess.run(argv + extra, cwd=ROOT, capture_output=True,
                           text=True, timeout=240)
            for extra in ([], ["--profile", str(prof)])]
    assert [r.returncode for r in runs] == [0, 0], runs[1].stderr
    plain, row = (json.loads(r.stdout) for r in runs)
    assert sorted(row) == sorted(plain)
    assert {k: row[k] for k in IDENTITY} == {k: plain[k] for k in IDENTITY}
    assert sorted(p.name for p in prof.iterdir()) == [
        f"rank{r}.json" for r in range(4)]
    for r in range(4):
        ops = _ops(prof / f"rank{r}.json")
        # every step's ghost exchange, two neighbours an axis
        assert ops.get("c10d::send", 0) >= 4 * (1 + 1) * (2 + 6)
        assert ops.get("c10d::recv_", 0) == ops["c10d::send"]


def test_a_card_trace_without_device_events_is_refused_and_not_kept(
        tmp_path):
    """What a card run does when CUPTI records nothing: here, where no
    card is present, the CUDA activity records nothing either. An
    earlier run's trace goes too, so nothing passes for this run's."""
    (tmp_path / "rank0.json").write_text("{}")
    with pytest.raises(RuntimeError, match="holds no kernel"):
        with trace.maybe_profile(str(tmp_path), torch.device("cuda")):
            torch.ones(64).add_(1)
    assert list(tmp_path.iterdir()) == []


def test_no_profile_dir_traces_nothing(tmp_path):
    with trace.maybe_profile(None, torch.device("cpu")):
        torch.ones(4).add_(1)
    with trace.maybe_profile("", torch.device("cpu")):
        pass
    assert list(tmp_path.iterdir()) == []


def test_trace_ops_counts_the_events_of_its_categories(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "dur": 2.5},
        {"ph": "X", "cat": "kernel", "name": "k", "dur": 1.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "dur": 4},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 9},
        {"ph": "i", "cat": "kernel", "name": "marker"},
    ]}))
    assert trace.trace_ops(path) == {
        "k": (2, 3.5), "Memcpy DtoD": (1, 4.0), "Memset": (1, 1.0)}
    assert trace.trace_ops(path, ("cpu_op",)) == {"aten::add": (1, 9.0)}
