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

Ported so far: the stencil driver on one device and on a rank mesh
(``bench/stencil.py``, every arm and shaping axis of the JAX driver's
but ``--dimsem``) with every TPU kernel of ``tpu_comm``; the STREAM
bandwidth driver (``bench/membw.py``); the collective sweep
(``bench/sweep.py``); the halo microbench and the deep-halo crossover
(``bench/halosweep.py``). ROADMAP.md queues the rest.
"""

__version__ = "0.1.0"
