"""The port stands alone: no JAX, no ``tpu_comm``, no build at import.

The card's machine has no JAX, so ``tpu_comm_torch`` and ``chip_smoke.py``
must import nothing of it, nor of the JAX package (not even its jax-free
modules), nor ``triton`` at module level (this CPU machine has none).
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tpu_comm_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    # what the mesh, collective, sweep, reshard, attention, halo and
    # overlap tests run on their spawned ranks, and the clock those ranks
    # install
    ROOT / "tests" / "torch_mesh_cases.py",
    ROOT / "tests" / "torch_coll_cases.py",
    ROOT / "tests" / "torch_reshard_cases.py",
    ROOT / "tests" / "torch_halo_cases.py",
    ROOT / "tests" / "torch_overlap_cases.py",
    ROOT / "tests" / "torch_fake_clock.py",
]
FORBIDDEN_ANYWHERE = ("jax", "jaxlib", "ml_dtypes", "tpu_comm")
FORBIDDEN_AT_TOP = ("triton",)


def _imports(tree: ast.AST):
    """(module, at_module_level) for every import in ``tree``."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", id(node) in top


def _root(module: str) -> str:
    return module.split(".")[0]


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT))
)
def test_port_imports_no_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [
        m for m, at_top in _imports(tree)
        if _root(m) in FORBIDDEN_ANYWHERE
        or (at_top and _root(m) in FORBIDDEN_AT_TOP)
    ]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_sees_the_whole_package():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {
        "tpu_comm_torch/cli.py",
        "tpu_comm_torch/kernels/jacobi3d.py",
        "tpu_comm_torch/bench/stencil.py",
        "tpu_comm_torch/bench/membw.py",
        "tpu_comm_torch/kernels/membw.py",
        "tpu_comm_torch/topo.py",
        "tpu_comm_torch/domain.py",
        "tpu_comm_torch/comm/patterns.py",
        "tpu_comm_torch/comm/launch.py",
        "tpu_comm_torch/comm/halo.py",
        "tpu_comm_torch/kernels/pack.py",
        "tpu_comm_torch/kernels/distributed.py",
        "tpu_comm_torch/kernels/stencil9.py",
        "tpu_comm_torch/kernels/stencil27.py",
        "tpu_comm_torch/comm/collectives.py",
        "tpu_comm_torch/bench/sweep.py",
        "tpu_comm_torch/bench/trace.py",
        "tpu_comm_torch/bench/halosweep.py",
        "tpu_comm_torch/bench/overlap.py",
        "tpu_comm_torch/bench/packbench.py",
        "tpu_comm_torch/kernels/graphs.py",
        "tpu_comm_torch/comm/reshard.py",
        "tpu_comm_torch/bench/reshard.py",
        "tpu_comm_torch/extras/ring_attention.py",
        "tpu_comm_torch/bench/attention.py",
        "tests/torch_mesh_cases.py",
        "tests/torch_coll_cases.py",
        "tests/torch_reshard_cases.py",
        "tests/torch_halo_cases.py",
        "tests/torch_overlap_cases.py",
        "tests/torch_fake_clock.py",
        "chip_smoke.py",
    } <= names


def test_importing_the_port_builds_nothing():
    """Import every module in a fresh interpreter: no JAX or triton is
    loaded, and no kernel library is built or loaded."""
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "import tpu_comm_torch",
        "for m in pkgutil.walk_packages(tpu_comm_torch.__path__,",
        "                               'tpu_comm_torch.'):",
        "    importlib.import_module(m.name)",
        "from tpu_comm_torch.kernels import _build",
        "assert _build.libraries.cache_info().currsize == 0",
        "loaded = [m for m in ('jax', 'triton', 'tpu_comm',",
        "          'torch.utils.cpp_extension') if m in sys.modules]",
        "assert not loaded, loaded",
        "print('ok', len([m for m in sys.modules",
        "                 if m.startswith('tpu_comm_torch')]))",
    ])
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    assert int(res.stdout.split()[1]) >= 21
