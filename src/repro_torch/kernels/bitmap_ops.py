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

A call is one device operation: the kernel needs no zeroed counter, and with
``out=(next, visited, count)`` it writes into the caller's buffers, so the
engine's per-level call allocates nothing.  The kernel's scratch (a sum slot
per block and a ticket) is allocated once per device and stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, StreamScratch
from repro_torch.kernels.ref import check_frontier_out

#: Bitmap length alignment (words), the JAX kernel's (8, 128) tile:
#: 1024 words = 32768 bits.
WORDS_PER_TILE = 1024
#: The kernel's scratch: kMaxBlocks sum slots and the ticket
#: (csrc/frontier_update.cu).
SCRATCH_WORDS = 132 * 4 + 1

KERNEL = CudaKernel("frontier_update", "frontier_update_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
])

def _check_bitmap(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"frontier_update: {name} must be a CUDA tensor, "
                         f"got device {t.device}")
    if t.dtype is not torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"frontier_update: {name} must be contiguous int32 [W] "
                         f"(uint32 bit-view), got {t.dtype} {tuple(t.shape)}")


#: The scratch of one (device index, stream), zeroed at allocation: two
#: streams never share a ticket.
scratch_for = StreamScratch(
    lambda device, _: (torch.zeros(SCRATCH_WORDS, dtype=torch.int32, device=device),))


def frontier_update(next_raw: torch.Tensor, visited: torch.Tensor, out=None):
    """Launch the fused (mask, merge, popcount) kernel.

    int32 [W] x2 on the card -> (int32 [W], int32 [W], int32 scalar tensor).
    ``out=(next, visited, count)`` writes into those buffers (same shapes;
    none may overlap an input or another output) and returns them.  The
    engine calls this once a level, so the checks stick to cheap tensor
    attributes and the stream comes as a raw handle.
    """
    _check_bitmap("next_raw", next_raw)
    _check_bitmap("visited", visited)
    w, dev = next_raw.shape[0], next_raw.get_device()
    if visited.shape[0] != w or visited.get_device() != dev:
        raise ValueError(f"frontier_update: shapes/devices differ: "
                         f"{tuple(next_raw.shape)}@{next_raw.device} vs "
                         f"{tuple(visited.shape)}@{visited.device}")
    if w % WORDS_PER_TILE:
        raise ValueError(f"bitmap length {w} not a multiple of {WORDS_PER_TILE}")
    if out is None:
        out = (torch.empty_like(next_raw), torch.empty_like(visited),
               torch.empty((), dtype=torch.int32, device=next_raw.device))
    ptrs = check_frontier_out(next_raw, visited, out)
    if (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16:
        raise ValueError("frontier_update: bitmaps must be 16-byte aligned")
    stream = torch._C._cuda_getCurrentRawStream(dev)
    KERNEL(*ptrs, *scratch_for(dev, stream), w, stream)
    return out
