"""Extras of the port (``tpu_comm/extras`` counterparts): long-context
attention over a 1D ring of ranks."""
