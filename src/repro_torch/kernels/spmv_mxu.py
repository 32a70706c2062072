"""Multi-source Boolean SpMV on the int8 tensor cores: the wrapper of
``csrc/spmv_mxu.cu``.

``counts[K, R] = A8[K, K] @ F8[K, R]`` with int32 accumulation: R BFS
frontiers advanced over the dense heavy core at once (callers threshold
``counts > 0``).  Counterpart of ``repro.kernels.spmv_mxu.spmv_mxu`` (a
Pallas TPU kernel), with its contract: K and R multiples of 128.  Exact for
every int8 value.  This wrapper only launches the CUDA kernel;
``kernels.ops.multi_source_spmv`` dispatches a CPU tensor to the plain
version instead.

The kernel is persistent and stream-K: :func:`spmv_plan` shares the
(tile, k step) units of the product evenly among at most one block per SM,
and the kernel recomputes the same shares from the plan's ``units`` and
``blocks``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._build import CudaKernel

TILE = 128
# The kernel's tile constants (csrc/spmv_mxu.cu).
BLOCK_M = 256      # rows of A per output tile
BLOCK_N = 128      # frontiers per output tile
BLOCK_K = 128      # k bytes per unit
#: Fewest units a block is given: below that its 4-stage ring never fills.
MIN_UNITS_PER_BLOCK = 4
#: SMs of an H100 SXM, the plan's default; the wrapper asks the device.
N_SMS = 132

KERNEL = CudaKernel("spmv_mxu", "spmv_mxu_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
])


class SpmvPlan(NamedTuple):
    m_tiles: int        # row tiles of BLOCK_M (the last one ragged if K % 256)
    n_tiles: int        # frontier tiles of BLOCK_N
    k_steps: int        # units per tile: k steps of BLOCK_K
    units: int          # m_tiles * n_tiles * k_steps
    blocks: int         # persistent blocks, at most one per SM
    ranges: tuple[tuple[int, int], ...]   # [start, end) units of each block
    split_tiles: tuple[int, ...]          # tiles shared by more than one block

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles


def owner(u: int, units: int, blocks: int) -> int:
    """The block whose even share holds unit ``u`` (block b owns
    ``[b U // P, (b + 1) U // P)``), as the kernel computes it."""
    return ((u + 1) * blocks - 1) // units


@functools.lru_cache(maxsize=64)
def spmv_plan(k: int, r: int, sms: int = N_SMS) -> SpmvPlan:
    """The stream-K partition of ``A8 [K, K] @ F8 [K, R]``, mirrored by
    ``spmv_mxu_launch``.

    Tile t covers rows ``(t // n_tiles) * 256`` and frontiers
    ``(t % n_tiles) * 128``; unit ``t * k_steps + j`` is its k step j.
    ``min(sms, units // 4)`` blocks (at least one) share the units evenly,
    in order: a block's share may start and end inside a tile, and such a
    tile is split (its blocks add their partial sums into a zeroed tile).
    """
    if k <= 0 or r <= 0 or k % TILE or r % TILE:
        raise ValueError(f"spmv_plan: K={k} and R={r} must be positive multiples "
                         f"of {TILE}")
    m_tiles = -(-k // BLOCK_M)
    n_tiles = r // BLOCK_N
    k_steps = k // BLOCK_K
    units = m_tiles * n_tiles * k_steps
    blocks = max(1, min(sms, units // MIN_UNITS_PER_BLOCK))
    starts = [b * units // blocks for b in range(blocks + 1)]
    split = tuple(t for t in range(m_tiles * n_tiles)
                  if owner(t * k_steps, units, blocks)
                  != owner((t + 1) * k_steps - 1, units, blocks))
    return SpmvPlan(m_tiles, n_tiles, k_steps, units, blocks,
                    tuple(zip(starts[:-1], starts[1:])), split)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (asked once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    plan = spmv_plan(k, r, sm_count(a_core8.device))
    # F transposed to K-major (the layout int8 wgmma takes), then the product
    ft = torch.empty((r, k), dtype=torch.int8, device=a_core8.device)
    out = torch.empty((k, r), dtype=torch.int32, device=a_core8.device)
    stream = torch.cuda.current_stream(a_core8.device).cuda_stream
    KERNEL(a_core8.data_ptr(), frontier8.data_ptr(), ft.data_ptr(), out.data_ptr(),
           k, r, plan.units, plan.blocks, stream)
    return out
