"""Time the face pack of two trees of the PyTorch port on one GPU, in
the order A, B, B, A: ``chip_smoke.py``'s ``measure_pack`` (the kernel,
the plain version, the library slices, ``copy_``, a cold-L2 pack and the
wrapper's ``call_ms``, in turns) and ``measure_pack_steps`` (the 3D
block step on a mesh of one with ``--pack kernel`` and ``--pack fused``,
in turns), one process a run.

Each run imports ``tpu_comm_torch`` from its tree (which builds its own
kernels into that tree's ``build/torch_ext/``) and the measuring code
from this checkout's ``chip_smoke.py``, so both trees are timed by the
same code. To hold a change against its parent commit::

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python3 scripts/compare_pack.py build/parent .

Every JSON line the runs print comes out with ``"tree"`` and ``"run"``
added; the exit code is the first failed run's, else 0.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = """
import importlib.util, sys, torch
sys.path.insert(0, {tree!r})
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from tpu_comm_torch.kernels import _build, kernels_for
_build.libraries()
cs.measure_pack(torch)
cs.measure_pack_steps(torch, {{3: kernels_for(3, 0)}})
"""


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print("usage: compare_pack.py TREE_A TREE_B", file=sys.stderr)
        return 2
    a, b = (str(Path(t).resolve()) for t in argv)
    for n, tree in enumerate((a, b, b, a)):
        code = RUN.format(tree=tree, smoke=str(ROOT / "chip_smoke.py"))
        proc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                              capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                print(line)
                continue
            print(json.dumps({"tree": tree, "run": n, **obj}), flush=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
