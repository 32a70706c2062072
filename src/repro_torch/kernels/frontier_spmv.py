"""Bottom-up BFS step over the dense heavy core: the wrapper of
``csrc/core_spmv.cu``.

Per row i of the packed Boolean core ``A [K, K/32]``: the least column j
with bit j set in both ``A[i]`` and the frontier bitmap, else ``BIG``.
Counterpart of ``repro.kernels.frontier_spmv.core_spmv`` (a Pallas TPU
kernel).  ``rows_per_tile`` keeps the JAX wrapper's knob: here it is the
number of rows (one warp each) a thread block handles.  A warp stops
reading its row at the first group of ``ref.CORE_GROUP_STEPS`` warp steps
that hits the frontier, so a launch reads about what its answer needs;
``words_read`` counts what it read.  This wrapper only launches the CUDA
kernel; ``kernels.ops.core_spmv`` dispatches a CPU tensor to the plain
version instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.ref import CORE_GROUP_STEPS

KERNEL = CudaKernel("core_spmv", "core_spmv_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
])


def core_spmv(a_core: torch.Tensor, frontier_bm: torch.Tensor, *,
              rows_per_tile: int = 8, words_read=None) -> torch.Tensor:
    """Min frontier-neighbour id per core row (BIG when none) -> int32 [K];
    ``words_read`` (an int64 scalar on the card, or None) gains the words of
    ``a_core`` the launch read."""
    for name, t, dim in (("a_core", a_core, 2), ("frontier_bm", frontier_bm, 1)):
        if t.device.type != "cuda":
            raise ValueError(f"core_spmv: {name} must be a CUDA tensor, got "
                             f"device {t.device}")
        if t.dtype != torch.int32 or t.dim() != dim:
            raise ValueError(f"core_spmv: {name} must be int32 with {dim} "
                             f"dims (uint32 bit-view), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"core_spmv: {name} must be contiguous and "
                             f"16-byte aligned")
    k, w = a_core.shape
    if frontier_bm.shape[0] != w or frontier_bm.device != a_core.device:
        raise ValueError(f"core_spmv: frontier {tuple(frontier_bm.shape)}@"
                         f"{frontier_bm.device} does not match a_core "
                         f"{tuple(a_core.shape)}@{a_core.device}")
    if w % 4:
        raise ValueError(f"core_spmv: row length {w} words is not a multiple of 4")
    if not 1 <= rows_per_tile <= 32 or k % rows_per_tile:
        raise ValueError(f"core_spmv: rows_per_tile={rows_per_tile} must be in "
                         f"[1, 32] and divide K={k}")
    if words_read is not None and (words_read.dtype != torch.int64 or words_read.dim()
                                   or words_read.device != a_core.device):
        raise ValueError(f"core_spmv: words_read must be an int64 scalar on "
                         f"{a_core.device}, got {words_read.dtype} "
                         f"{tuple(words_read.shape)} on {words_read.device}")
    out = torch.empty((k,), dtype=torch.int32, device=a_core.device)
    stream = torch.cuda.current_stream(a_core.device).cuda_stream
    KERNEL(a_core.data_ptr(), frontier_bm.data_ptr(), out.data_ptr(), k, w,
           rows_per_tile, CORE_GROUP_STEPS,
           None if words_read is None else words_read.data_ptr(), stream)
    return out
