"""Fused xDeepFM CIN layer: the wrapper of ``csrc/cin_layer.cu``.

``out[b, h, d] = sum_ij w[h, i, j] * x0[b, i, d] * xl[b, j, d]`` for fp32
x0 [B, F0, D], xl [B, Fl, D] and w [H, F0, Fl], without the [B, F0, Fl, D]
outer product in memory.  Counterpart of ``repro.kernels.cin.cin_layer`` (a
Pallas TPU kernel); it takes any B and D.  The kernel is one GEMM on the
tensor cores (``wgmma``, three TF32 passes: fp32-level error, see the
source's header): rows n = b * D + d, columns the filters, K the pairs
(i, j).  It has no backward, so it refuses inputs that would need one.  This
wrapper only launches the CUDA kernel; ``kernels.ops.cin_layer`` dispatches
a CPU tensor to the plain version instead.

:func:`cin_plan` plans a call: the ``wgmma`` width and filter tiles, the K
order and its padding, the ring's stages and shared memory, and how many
blocks share the K units of one row tile (``splits``), so that a small batch
still keeps the card busy.  :func:`weight_layout` is the plain version of
the kernel's prep launch (w split into TF32 hi and lo in the K order).
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
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
])

# The kernel's constants (csrc/cin_layer.cu).
#: ``wgmma`` widths (filters per tile) the kernel is built for.
N_TILES = (16, 32, 64, 128, 200)
BLOCK_ROWS = 128      # rows n per block: two warpgroups of 64
BOX_K = 32            # floats of k per TMA box (one 128-byte swizzle row)
STEPS_PER_BOX = BOX_K // 8
CHUNK_IB = 5          # 8-wide i blocks per K chunk (a thread's x0 in registers)
MAX_STAGES = 8
SMEM_LIMIT = 232448   # dynamic shared memory a block can use
#: SMs of an H100 SXM, the plan's default; the wrapper asks the device.  A
#: block fills one SM (its ring leaves room for no second block).
N_SMS = 132
#: A block's fixed cost (barriers, x0 loads, filling the ring, the last
#: flush) in k8 steps of its K loop: it makes the plan prefer fewer
#: splits among grids of equal waves x depth.
BLOCK_OVERHEAD_STEPS = 16


def stages_for(n_tile: int) -> int:
    """Ring stages of an ``n_tile``-wide tile: [n_tile x 32] box pairs
    (w_hi, w_lo; 256 n_tile bytes) that fit beside the alignment slack and
    the barriers."""
    return min(MAX_STAGES, (SMEM_LIMIT - 1024 - 16 * MAX_STAGES) // (256 * n_tile))


def smem_for(n_tile: int) -> int:
    s = stages_for(n_tile)
    return s * 256 * n_tile + 1024 + 16 * s


class CinPlan(NamedTuple):
    n_tile: int                     # wgmma N: filters per tile
    n_tiles: int                    # filter tiles (gridDim.y)
    h_pad: int                      # n_tiles * n_tile
    ib_total: int                   # 8-wide i blocks: ceil(F0 / 8)
    units: int                      # K units (chunk, j): chunks * Fl
    k_steps: int                    # k8 steps of K: Fl * ib_total
    k_pad: int                      # K padded to whole boxes (floats)
    m_tiles: int                    # 128-row tiles (gridDim.x)
    grid: tuple[int, int, int]      # (m_tiles, n_tiles, splits)
    splits: int                     # blocks that share one tile's K units
    unit_ranges: tuple[tuple[int, int], ...]   # [u_lo, u_hi) of each split
    step_ranges: tuple[tuple[int, int], ...]   # the k8 steps of each split
    stages: int                     # ring stages of (w_hi, w_lo) boxes
    w_split_shape: tuple[int, int, int]        # [2, h_pad, k_pad] weight scratch
    scratch_shape: tuple[int, ...] | None      # [splits, B, H, D] partials
    smem_bytes: int

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)


def tile_width(h: int) -> tuple[int, int]:
    """(wgmma width, filter tiles) for H filters: the fewest tiles of at
    most 200 (wider ones spill: the accumulator is N / 2 registers a
    thread), each the narrowest built width that holds its share."""
    n_tiles = max(1, -(-h // N_TILES[-1]))
    need = -(-h // n_tiles)
    return min(n for n in N_TILES if n >= need), n_tiles


def unit_step(u: int, fl: int, ib_total: int) -> int:
    """First k8 step of K unit u = c * Fl + j (the chunks before c are
    full); the number of k8 steps for u past the last unit."""
    chunks = -(-ib_total // CHUNK_IB)
    if u >= chunks * fl:
        return fl * ib_total
    c, j = divmod(u, fl)
    return CHUNK_IB * fl * c + j * min(CHUNK_IB, ib_total - CHUNK_IB * c)


def k_index(f0: int, fl: int) -> torch.Tensor:
    """int64 [k_pad]: for each k of the kernel's K order, the flat index
    i * Fl + j of w's last two axes, or -1 where K is padding."""
    ib_total = -(-f0 // 8)
    k_steps = fl * ib_total
    k_pad = -(-k_steps // STEPS_PER_BOX) * BOX_K
    idx = torch.full((k_pad,), -1, dtype=torch.int64)
    chunks = -(-ib_total // CHUNK_IB)
    for c in range(chunks):
        nib = min(CHUNK_IB, ib_total - CHUNK_IB * c)
        for j in range(fl):
            q0 = unit_step(c * fl + j, fl, ib_total)
            i = 8 * (CHUNK_IB * c) + torch.arange(8 * nib)
            k = 8 * q0 + torch.arange(8 * nib)
            keep = i < f0
            idx[k[keep]] = i[keep] * fl + j
    return idx


def weight_layout(w: torch.Tensor, plan: CinPlan) -> torch.Tensor:
    """The prep launch's output in plain torch: fp32 [2, h_pad, k_pad],
    w_hi = tf32(w) then w_lo = tf32(w - w_hi), in the kernel's K order,
    zero in the padding."""
    h, f0, fl = w.shape
    idx = k_index(f0, fl).to(w.device)
    flat = torch.zeros((plan.h_pad, f0 * fl + 1), dtype=torch.float32, device=w.device)
    flat[:h, :-1] = w.reshape(h, f0 * fl)
    v = flat[:, idx]              # index -1: the zero column
    hi = tf32_round(v)
    return torch.stack([hi, tf32_round(v - hi)])


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (ties away from zero), as
    ``cvt.rna.tf32.f32`` and the kernel's integer rounding give it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_cost(tiles: int, k_steps: int, splits: int, sms: int = N_SMS) -> float:
    """Modelled time of a grid of ``tiles`` output tiles whose K is split
    ``splits`` ways: waves of one block per SM, times the depth of a block
    (its k8 steps plus its fixed cost)."""
    return -(-tiles * splits // sms) * (-(-k_steps // splits) + BLOCK_OVERHEAD_STEPS)


def cin_plan(b: int, f0: int, fl: int, h: int, d: int, *, splits: int | None = None,
             sms: int = N_SMS) -> CinPlan:
    """The launch plan of one layer, mirrored by ``cin_layer_launch``.

    One block per 128 rows n and filter tile.  K is split over the number
    of blocks (1 to the number of K units, in ranges of units that differ by
    at most one) with the least :func:`split_cost`, the fewest among equals:
    at B = 262,144 one, at B = 512 three (120 blocks, one wave).
    ``splits`` overrides the choice.
    """
    n_tile, n_tiles = tile_width(h)
    ib_total = -(-f0 // 8)
    units = -(-ib_total // CHUNK_IB) * fl
    k_steps = fl * ib_total
    k_pad = -(-k_steps // STEPS_PER_BOX) * BOX_K
    m_tiles = -(-(b * d) // BLOCK_ROWS)
    tiles = m_tiles * n_tiles
    if splits is None:
        splits = 1
        if tiles:   # an empty output launches nothing
            splits = min(range(1, units + 1),
                         key=lambda s: (split_cost(tiles, k_steps, s, sms), s))
    if not 1 <= splits <= units:
        raise ValueError(f"cin_plan: splits must be in [1, {units}] (the K units), "
                         f"got {splits}")
    bounds = [z * units // splits for z in range(splits + 1)]
    steps = [unit_step(u, fl, ib_total) for u in bounds]
    return CinPlan(
        n_tile=n_tile, n_tiles=n_tiles, h_pad=n_tile * n_tiles, ib_total=ib_total,
        units=units, k_steps=k_steps, k_pad=k_pad, m_tiles=m_tiles,
        grid=(m_tiles, n_tiles, splits), splits=splits,
        unit_ranges=tuple(zip(bounds[:-1], bounds[1:])),
        step_ranges=tuple(zip(steps[:-1], steps[1:])),
        stages=stages_for(n_tile), w_split_shape=(2, n_tile * n_tiles, k_pad),
        scratch_shape=(splits, b, h, d) if splits > 1 else None,
        smem_bytes=smem_for(n_tile))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (asked once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"cin_layer: {name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != torch.float32 or t.dim() != 3:
        raise ValueError(f"cin_layer: {name} must be float32 with 3 dims, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"cin_layer: {name} must be contiguous and 16-byte aligned")
    if t.device != like.device:
        raise ValueError(f"cin_layer: {name} is on {t.device}, x0 on {like.device}")
    if t.requires_grad and torch.is_grad_enabled():
        raise ValueError("cin_layer: the CIN kernel has no backward; call it "
                         "under torch.no_grad() or torch.inference_mode()")


def cin_layer(x0: torch.Tensor, xl: torch.Tensor, w: torch.Tensor, *,
              splits: int | None = None) -> torch.Tensor:
    """One CIN layer on the card -> fp32 [B, H, D].  ``splits`` overrides
    the plan's split of K (for timing the plan's choice)."""
    for name, t in (("x0", x0), ("xl", xl), ("w", w)):
        _check(name, t, x0)
    b, f0, d = x0.shape
    h, wf0, fl = w.shape
    if xl.shape[0] != b or xl.shape[2] != d or wf0 != f0 or min(f0, fl) < 1:
        raise ValueError(f"cin_layer: shapes x0 {tuple(x0.shape)}, xl "
                         f"{tuple(xl.shape)}, w {tuple(w.shape)} do not agree")
    plan = cin_plan(b, f0, fl, h, d, splits=splits, sms=sm_count(x0.device))
    out = torch.empty((b, h, d), dtype=torch.float32, device=x0.device)
    if not out.numel():
        return out
    w_split = torch.empty(plan.w_split_shape, dtype=torch.float32, device=x0.device)
    scratch = None
    if plan.scratch_shape is not None:
        scratch = torch.empty(plan.scratch_shape, dtype=torch.float32, device=x0.device)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    KERNEL(x0.data_ptr(), xl.data_ptr(), w.data_ptr(), out.data_ptr(), w_split.data_ptr(),
           None if scratch is None else scratch.data_ptr(), b, f0, fl, h, d,
           plan.n_tile, plan.splits, 0, stream)
    return out


def prep_weights(w: torch.Tensor) -> torch.Tensor:
    """The kernel's prep launch alone (the entry point's mode 1): w split
    into TF32 hi and lo in the K order, [2, h_pad, k_pad], on the card.
    For checking the layout against :func:`weight_layout`."""
    _check("w", w, w)
    h, f0, fl = w.shape
    plan = cin_plan(0, f0, fl, h, 1)
    w_split = torch.empty(plan.w_split_shape, dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    KERNEL(None, None, w.data_ptr(), None, w_split.data_ptr(), None, 0, f0, fl, h, 1,
           plan.n_tile, 1, 1, stream)
    return w_split
