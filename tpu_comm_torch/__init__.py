"""tpu_comm_torch — the PyTorch/CUDA port of tpu_comm, for NVIDIA Hopper.

A second package beside the JAX one (``tpu_comm``), which stays the
reference. Module names mirror ``tpu_comm`` so each counterpart is easy
to find. Each Pallas kernel of the TPU package becomes a kernel written
by hand in CUDA C++ (``csrc/``), built at first use; beside each kernel
sits a plain PyTorch version of the same function, which the CPU runs and
the card's checks compare against.

The port imports torch and numpy, never jax nor anything of ``tpu_comm``.
Its entry points run on the CUDA card unless the caller asks for the CPU
(``--backend cpu``).

Ported so far: the single-device stencil driver (``bench/stencil.py``)
and its three stream kernels (``kernels/jacobi{1,2,3}d.py``); the STREAM
bandwidth driver (``bench/membw.py``) and its four kernels
(``kernels/membw.py``).
"""

__version__ = "0.1.0"
