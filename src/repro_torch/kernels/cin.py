"""Fused xDeepFM CIN layer: the wrapper of ``csrc/cin_layer.cu``.

``out[b, h, d] = sum_ij w[h, i, j] * x0[b, i, d] * xl[b, j, d]`` for fp32
x0 [B, F0, D], xl [B, Fl, D] and w [H, F0, Fl], without the [B, F0, Fl, D]
outer product in memory.  Counterpart of ``repro.kernels.cin.cin_layer`` (a
Pallas TPU kernel); it takes any B and D.  The kernel runs on the tensor
cores in three TF32 passes (fp32-level error, see the source's header) and
has no backward, so it refuses inputs that would need one.  This wrapper
only launches the CUDA kernel; ``kernels.ops.cin_layer`` dispatches a CPU
tensor to the plain version instead.

:func:`cin_plan` chooses the grid: how many blocks share the F0 sum of one
output tile (``splits``), so that a small batch still keeps the card busy,
and how many 16-filter tiles a block holds (``warps``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel("cin_layer", "cin_layer_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
])

# The kernel's tile constants (csrc/cin_layer.cu).
BLOCK_COLS = 80       # columns n = b * D + d per block
TILE_H = 16           # filters per warp (one mma m16 tile)
MAX_WARPS = 16
STAGE = BLOCK_COLS + 4
RING = 4 * TILE_H * 8  # floats of one warp's ring of w tiles
MAX_K_STEPS = 32      # 8 values of j each
MAX_I_CHUNK = 64
#: SMs of an H100 SXM, the plan's default; the wrapper asks the device.  A
#: block of the kernel fills one SM (its shared memory and registers leave
#: room for no second block).
N_SMS = 132
#: A block's fixed cost (loading its xl rows, storing its output) in units
#: of one i of the F0 sum: it makes the plan prefer fewer splits among
#: grids of equal waves x depth (chip_smoke phase 10 times the splits at
#: B = 512, PERF.md).
BLOCK_OVERHEAD_I = 0.8


class CinPlan(NamedTuple):
    h_pad: int                      # H rounded up to whole 16-filter tiles
    warps: int                      # 16-filter tiles per block
    grid: tuple[int, int, int]      # (column blocks, filter blocks, splits)
    splits: int                     # blocks that share one tile's F0 sum
    i_ranges: tuple[tuple[int, int], ...]   # [i_lo, i_hi) of each split
    scratch_shape: tuple[int, ...] | None   # [splits, B, H, D] partials
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)


def split_cost(tiles: int, f0: int, splits: int, sms: int = N_SMS) -> float:
    """Modelled time of a grid of ``tiles`` output tiles whose F0 sum is
    split ``splits`` ways: waves of one block per SM, times the depth of a
    block (its i values plus its fixed cost)."""
    return -(-tiles * splits // sms) * (-(-f0 // splits) + BLOCK_OVERHEAD_I)


def cin_plan(b: int, f0: int, fl: int, h: int, d: int, *, splits: int | None = None,
             sms: int = N_SMS) -> CinPlan:
    """The launch plan of one layer, mirrored by ``cin_layer_launch``.

    One block per 80 columns and up to 16 filter tiles.  The F0 sum is
    split over the number of blocks (1 to F0, in ranges that differ by at
    most one) with the least :func:`split_cost`, the fewest splits among
    equals: at B = 262,144 one, at B = 512 two (128 blocks, one wave).
    ``splits`` overrides the choice.
    """
    m_tiles = -(-h // TILE_H)
    col_blocks = -(-(b * d) // BLOCK_COLS)
    warps = max(1, min(m_tiles, MAX_WARPS))
    h_blocks = -(-m_tiles // warps)
    tiles = col_blocks * h_blocks
    if splits is None:
        splits = 1
        if tiles:   # an empty output launches nothing
            splits = min(range(1, f0 + 1), key=lambda s: (split_cost(tiles, f0, s, sms), s))
    if not 1 <= splits <= f0:
        raise ValueError(f"cin_plan: splits must be in [1, F0 = {f0}], got {splits}")
    base, rem = divmod(f0, splits)
    starts = [z * base + min(z, rem) for z in range(splits + 1)]
    ks_chunk = min(-(-fl // 8), MAX_K_STEPS)
    i_chunk = min(-(-f0 // splits), MAX_I_CHUNK)
    smem = 4 * (max(ks_chunk * BLOCK_COLS * 16, warps * TILE_H * STAGE)
                + i_chunk * BLOCK_COLS + warps * RING)
    return CinPlan(
        h_pad=m_tiles * TILE_H, warps=warps,
        grid=(col_blocks, h_blocks, splits), splits=splits,
        i_ranges=tuple(zip(starts[:-1], starts[1:])),
        scratch_shape=(splits, b, h, d) if splits > 1 else None,
        smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (asked once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def cin_layer(x0: torch.Tensor, xl: torch.Tensor, w: torch.Tensor, *,
              splits: int | None = None) -> torch.Tensor:
    """One CIN layer on the card -> fp32 [B, H, D].  ``splits`` overrides
    the plan's split of the F0 sum (for timing the plan's choice)."""
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
    plan = cin_plan(b, f0, fl, h, d, splits=splits, sms=sm_count(x0.device))
    if fl % 4:   # the kernel copies w rows 16 bytes at a time
        w = torch.nn.functional.pad(w, (0, 4 - fl % 4))
    out = torch.empty((b, h, d), dtype=torch.float32, device=x0.device)
    scratch = None
    if plan.scratch_shape is not None and out.numel():
        scratch = torch.empty(plan.scratch_shape, dtype=torch.float32, device=x0.device)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    KERNEL(x0.data_ptr(), xl.data_ptr(), w.data_ptr(), out.data_ptr(),
           None if scratch is None else scratch.data_ptr(), b, f0, fl, h, d,
           w.shape[2], plan.warps, plan.splits, stream)
    return out
