"""Fused xDeepFM CIN layer: the wrapper of ``csrc/cin_layer.cu``.

``out[b, h, d] = sum_ij w[h, i, j] * x0[b, i, d] * xl[b, j, d]`` for fp32
x0 [B, F0, D], xl [B, Fl, D] and w [H, F0, Fl], without the [B, F0, Fl, D]
outer product in memory.  Counterpart of ``repro.kernels.cin.cin_layer`` (a
Pallas TPU kernel); it takes any B and D.  The kernel has no backward, so
it refuses inputs that would need one.  This wrapper only launches the
CUDA kernel; ``kernels.ops.cin_layer`` dispatches a CPU tensor to the plain
version instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel("cin_layer", "cin_layer_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
])


def cin_layer(x0: torch.Tensor, xl: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One CIN layer on the card -> fp32 [B, H, D]."""
    for name, t in (("x0", x0), ("xl", xl), ("w", w)):
        if t.device.type != "cuda":
            raise ValueError(f"cin_layer: {name} must be a CUDA tensor, got "
                             f"device {t.device}")
        if t.dtype != torch.float32 or t.dim() != 3:
            raise ValueError(f"cin_layer: {name} must be float32 with 3 dims, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"cin_layer: {name} must be contiguous and "
                             f"16-byte aligned")
        if t.device != x0.device:
            raise ValueError(f"cin_layer: {name} is on {t.device}, x0 on {x0.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError("cin_layer: the CIN kernel has no backward; call it "
                             "under torch.no_grad() or torch.inference_mode()")
    b, f0, d = x0.shape
    h, wf0, fl = w.shape
    if xl.shape[0] != b or xl.shape[2] != d or wf0 != f0 or min(f0, fl) < 1:
        raise ValueError(f"cin_layer: shapes x0 {tuple(x0.shape)}, xl "
                         f"{tuple(xl.shape)}, w {tuple(w.shape)} do not agree")
    out = torch.empty((b, h, d), dtype=torch.float32, device=x0.device)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    KERNEL(x0.data_ptr(), xl.data_ptr(), w.data_ptr(), out.data_ptr(), b, f0,
           fl, h, d, stream)
    return out
