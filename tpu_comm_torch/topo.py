"""Device selection for the port (the single-device part of
``tpu_comm/topo.py`` ``get_devices``).

The port runs on the card unless the caller asks for the CPU. Asking for
``cuda`` where there is none is an error, never a quiet run on the CPU.
"""

from __future__ import annotations

import torch

BACKENDS = ("cuda", "cpu")


def get_device(backend: str = "cuda") -> torch.device:
    """The device for ``backend``: the current CUDA device, or the CPU."""
    if backend == "cpu":
        return torch.device("cpu")
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend=cuda requested but no CUDA device is available "
                "(torch.cuda.is_available() is False); pass --backend cpu "
                "to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
