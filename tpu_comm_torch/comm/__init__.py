"""Communication layer of the port (``tpu_comm/comm`` counterparts):
the pattern tables, the rank launcher and the ghost-cell halo exchange
over ``torch.distributed`` (NCCL for CUDA tensors, gloo for CPU ones)."""
