"""Benchmark drivers of the port (``tpu_comm/bench`` counterparts)."""
