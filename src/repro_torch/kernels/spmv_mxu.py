"""Multi-source Boolean SpMV on the int8 tensor cores: the wrapper of
``csrc/spmv_mxu.cu``.

``counts[K, R] = A8[K, K] @ F8[K, R]`` with int32 accumulation: R BFS
frontiers advanced over the dense heavy core at once (callers threshold
``counts > 0``).  Counterpart of ``repro.kernels.spmv_mxu.spmv_mxu`` (a
Pallas TPU kernel), with its contract: K and R multiples of 128.  Exact for
every int8 value.  This wrapper only launches the CUDA kernel;
``kernels.ops.multi_source_spmv`` dispatches a CPU tensor to the plain
version instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel

TILE = 128

KERNEL = CudaKernel("spmv_mxu", "spmv_mxu_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_void_p,
])


def check_shapes(a_core8: torch.Tensor, frontier8: torch.Tensor) -> None:
    """The TPU kernel's contract: A8 [K, K], F8 [K, R], K and R multiples of 128."""
    if a_core8.dim() != 2 or frontier8.dim() != 2:
        raise ValueError(f"spmv_mxu: a_core8 {tuple(a_core8.shape)} and frontier8 "
                         f"{tuple(frontier8.shape)} must be 2-D")
    k, r = frontier8.shape
    if tuple(a_core8.shape) != (k, k):
        raise ValueError(f"spmv_mxu: a_core8 {tuple(a_core8.shape)} must be "
                         f"[K, K] with K = frontier8.shape[0] = {k}")
    if k % TILE or r % TILE or k == 0 or r == 0:
        raise ValueError(f"spmv_mxu: K={k} and R={r} must be positive multiples "
                         f"of {TILE}")


def spmv_mxu(a_core8: torch.Tensor, frontier8: torch.Tensor) -> torch.Tensor:
    """int32 [K, R] neighbour counts for R simultaneous frontiers, on the card."""
    for name, t in (("a_core8", a_core8), ("frontier8", frontier8)):
        if t.device.type != "cuda":
            raise ValueError(f"spmv_mxu: {name} must be a CUDA tensor, got "
                             f"device {t.device}")
        if t.dtype != torch.int8:
            raise ValueError(f"spmv_mxu: {name} must be int8, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"spmv_mxu: {name} must be contiguous and "
                             f"16-byte aligned")
    if frontier8.device != a_core8.device:
        raise ValueError(f"spmv_mxu: frontier8 on {frontier8.device}, a_core8 on "
                         f"{a_core8.device}")
    check_shapes(a_core8, frontier8)
    k, r = frontier8.shape
    out = torch.empty((k, r), dtype=torch.int32, device=a_core8.device)
    stream = torch.cuda.current_stream(a_core8.device).cuda_stream
    KERNEL(a_core8.data_ptr(), frontier8.data_ptr(), out.data_ptr(), k, r, stream)
    return out
