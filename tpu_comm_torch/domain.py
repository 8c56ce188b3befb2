"""Domain decomposition: global grid <-> per-rank blocks (port of
``tpu_comm/domain.py`` ``Decomposition``).

In the JAX package the global field is one array sharded over the mesh.
Here each rank holds its own block as a plain tensor: ``scatter`` slices
this rank's block out of the global NumPy field, which every rank builds
identically from the same seed or file, and ``gather`` collects the blocks
on rank 0 for ``--verify`` and ``--dump``. Ghost cells never live in a
block; ``comm.halo`` receives them beside it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_comm_torch.kernels.tiling import from_numpy_field, to_numpy_field
from tpu_comm_torch.topo import CartMesh


@dataclass(frozen=True)
class Decomposition:
    """Block decomposition of a d-dim global grid over a d-axis CartMesh.
    Array axis ``i`` is split over mesh axis ``cart.axis_names[i]`` (use a
    size-1 mesh axis for an unsplit array axis)."""

    cart: CartMesh
    global_shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.global_shape) != len(self.cart.axis_names):
            raise ValueError(
                f"grid ndim {len(self.global_shape)} != mesh ndim "
                f"{len(self.cart.axis_names)}"
            )
        for n, p, name in zip(
            self.global_shape, self.cart.shape, self.cart.axis_names
        ):
            if n % p != 0:
                raise ValueError(
                    f"global dim {n} not divisible by mesh axis {name!r} "
                    f"size {p} (pad the grid or choose a different mesh)"
                )

    @property
    def local_shape(self) -> tuple[int, ...]:
        return tuple(
            n // p for n, p in zip(self.global_shape, self.cart.shape)
        )

    def global_offset(self, coords: tuple[int, ...]) -> tuple[int, ...]:
        """Global index of local element (0,...,0) of the block at mesh
        ``coords``."""
        return tuple(c * ln for c, ln in zip(coords, self.local_shape))

    def _block_slices(self, coords: tuple[int, ...]) -> tuple[slice, ...]:
        return tuple(
            slice(o, o + ln)
            for o, ln in zip(self.global_offset(coords), self.local_shape)
        )

    def scatter(self, host_array: np.ndarray, device="cpu",
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """This rank's block of the global ``host_array`` as a contiguous
        tensor on ``device`` (converted to ``dtype`` when given)."""
        if tuple(host_array.shape) != self.global_shape:
            raise ValueError(
                f"array shape {host_array.shape} != {self.global_shape}"
            )
        block = host_array[self._block_slices(self.cart.coords)]
        return from_numpy_field(block, device, dtype)

    def gather(self, block: torch.Tensor) -> np.ndarray | None:
        """The global field on rank 0 as NumPy (bfloat16 widened to
        float32), None on every other rank. Collective: every rank of
        the default group calls it."""
        import torch.distributed as dist

        if tuple(block.shape) != self.local_shape:
            raise ValueError(
                f"block shape {tuple(block.shape)} != {self.local_shape}"
            )
        world = self.cart.world
        if world == 1:
            return to_numpy_field(block)
        block = block.contiguous()
        parts = None
        if self.cart.rank == 0:
            parts = [torch.empty_like(block) for _ in range(world)]
        dist.gather(block, parts, dst=0)
        if parts is None:
            return None
        first = to_numpy_field(parts[0])
        out = np.empty(self.global_shape, dtype=first.dtype)
        for rank, part in enumerate(parts):
            out[self._block_slices(self.cart.coords_of(rank))] = (
                to_numpy_field(part)
            )
        return out
