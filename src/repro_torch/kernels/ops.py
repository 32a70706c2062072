"""Public kernel entry points, dispatched on the tensor's device.

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a
tensor on the card goes to the hand-written CUDA kernel, which is built on
first use and raises if it cannot be built or launched.  There is no
fallback from the card to the plain version and no switch that routes CUDA
tensors elsewhere.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitmap_ops, frontier_spmv, ref

#: name -> kernel object of every hand-written kernel (its ``launches``
#: counts the launches the CUDA runtime accepted).
KERNELS = {
    "frontier_update": bitmap_ops.KERNEL,
    "core_spmv": frontier_spmv.KERNEL,
}


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def frontier_update(next_raw: torch.Tensor, visited: torch.Tensor):
    """Fused: next &= ~visited; visited |= next; count = popcount(next)."""
    if next_raw.device.type == "cpu":
        return ref.frontier_update_ref(next_raw, visited)
    return bitmap_ops.frontier_update(next_raw, visited)


def core_spmv(a_core: torch.Tensor, frontier_bm: torch.Tensor, *,
              rows_per_tile: int = 8) -> torch.Tensor:
    """Bottom-up step over the dense core: min frontier neighbour per row."""
    if a_core.device.type == "cpu":
        return ref.core_spmv_ref(a_core, frontier_bm)
    return frontier_spmv.core_spmv(a_core, frontier_bm,
                                   rows_per_tile=rows_per_tile)
