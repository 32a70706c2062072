"""Fused frontier bitmap update: the wrapper of ``csrc/frontier_update.cu``.

The per-level epilogue of the bitmap-resident BFS engine::

    next    = next_raw & ~visited
    visited = visited | next
    count   = popcount(next)          # |in| for the direction switch

Counterpart of ``repro.kernels.bitmap_ops.frontier_update`` (a Pallas TPU
kernel).  Bitmaps are int32 bit-views ``[W]`` with ``W % 1024 == 0`` (see
``core.heavy.padded_bitmap_words``).  This wrapper only launches the CUDA
kernel; ``kernels.ops.frontier_update`` dispatches a CPU tensor to the plain
version instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel

#: Bitmap length alignment (words), the JAX kernel's (8, 128) tile:
#: 1024 words = 32768 bits.
WORDS_PER_TILE = 1024

KERNEL = CudaKernel("frontier_update", "frontier_update_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
])


def _check_bitmap(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"frontier_update: {name} must be a CUDA tensor, "
                         f"got device {t.device}")
    if t.dtype != torch.int32 or t.dim() != 1:
        raise ValueError(f"frontier_update: {name} must be int32 [W] "
                         f"(uint32 bit-view), got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"frontier_update: {name} must be contiguous and "
                         f"16-byte aligned")


def frontier_update(next_raw: torch.Tensor, visited: torch.Tensor):
    """Launch the fused (mask, merge, popcount) kernel.

    int32 [W] x2 on the card -> (int32 [W], int32 [W], int32 scalar tensor).
    """
    _check_bitmap("next_raw", next_raw)
    _check_bitmap("visited", visited)
    w = next_raw.shape[0]
    if visited.shape != next_raw.shape or visited.device != next_raw.device:
        raise ValueError(f"frontier_update: shapes/devices differ: "
                         f"{tuple(next_raw.shape)}@{next_raw.device} vs "
                         f"{tuple(visited.shape)}@{visited.device}")
    if w % WORDS_PER_TILE:
        raise ValueError(f"bitmap length {w} not a multiple of {WORDS_PER_TILE}")
    out_next = torch.empty_like(next_raw)
    out_vis = torch.empty_like(visited)
    count = torch.empty((), dtype=torch.int32, device=next_raw.device)
    stream = torch.cuda.current_stream(next_raw.device).cuda_stream
    KERNEL(next_raw.data_ptr(), visited.data_ptr(), out_next.data_ptr(),
           out_vis.data_ptr(), count.data_ptr(), w, stream)
    return out_next, out_vis, count
