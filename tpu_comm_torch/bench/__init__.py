"""Benchmark drivers of the port (``tpu_comm/bench`` counterparts).

The STREAM quartet's names (the port's copies of
``tpu_comm/bench/__init__.py`` ``MEMBW_OPS`` and of
``tpu_comm/bench/membw.py`` ``TRAFFIC``) and the port's membw arm names.
The JAX package names the arms after Pallas; the port names them after
what they run:

    JAX           port
    lax           torch     one PyTorch op per pass (not a kernel)
    pallas        chunked   csrc/membw.cu membw_unary / membw_binary
    pallas-stream stream    csrc/membw.cu membw_stream (copy only)
    pallas-dma    dma       csrc/membw.cu membw_dma (copy only)
    both          both      chunked + torch

A JAX name is refused with an error that names the port's arm; there are
no aliases.
"""

MEMBW_OPS = ("copy", "scale", "add", "triad")
#: element visits (reads + writes) per iteration, STREAM convention
TRAFFIC = {"copy": 2, "scale": 2, "add": 3, "triad": 3}
MEMBW_IMPLS = ("torch", "chunked", "stream", "dma")
#: the JAX package's arm name -> the port's
JAX_MEMBW_IMPLS = {
    "lax": "torch",
    "pallas": "chunked",
    "pallas-stream": "stream",
    "pallas-dma": "dma",
}
