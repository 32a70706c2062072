"""Plain PyTorch versions of the hand-written kernels (the test oracles).

Bitmaps are carried as ``int32`` tensors holding the uint32 bit patterns of
the JAX package's words (``np.ndarray.view(np.int32)`` at the boundary):
PyTorch's ``uint32`` lacks ``>>``, ``~``, ``+`` and ``min``.  Arithmetic that
needs the unsigned value widens to int64 first (:func:`to_u64`), and a word
computed in int64 comes back with :func:`wrap_i32`, never by an
out-of-range cast.
"""
from __future__ import annotations

import torch

BIG = 2**30
_U32 = 0xFFFFFFFF


def to_u64(w: torch.Tensor) -> torch.Tensor:
    """int32 bit-view words -> int64 holding the unsigned value [0, 2^32)."""
    return w.to(torch.int64) & _U32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the int32 bit-view of the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def popcount_u32(w: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of each 32-bit word (int32 bit-view in, int32 out)."""
    w = to_u64(w)
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def ctz_u32(w: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of each 32-bit word; 32 for a zero word."""
    u = to_u64(w)
    low = u & -u  # lowest set bit (0 if u == 0)
    return torch.where(u == 0, torch.full_like(u, 32),
                       popcount_u32(low - 1).to(torch.int64)).to(torch.int32)


def frontier_update_ref(next_raw: torch.Tensor, visited: torch.Tensor):
    """next = next_raw & ~visited; visited |= next; count = popcount(next).

    int32 [W] x2 -> (int32 [W], int32 [W], int32 scalar).
    """
    nxt = next_raw & ~visited
    vis = visited | nxt
    count = popcount_u32(nxt).sum().to(torch.int32)
    return nxt, vis, count


def core_spmv_ref(a_core: torch.Tensor, frontier_bm: torch.Tensor) -> torch.Tensor:
    """Per core row i: the least column j with A[i, j] & frontier[j], else BIG.

    a_core: int32 [K, W]; frontier_bm: int32 [W]; returns int32 [K].
    """
    k, w = a_core.shape
    hits = a_core & frontier_bm[None, :]
    word_idx = torch.arange(w, dtype=torch.int32, device=a_core.device) * 32
    cand = torch.where(hits != 0, word_idx[None, :] + ctz_u32(hits),
                       torch.tensor(BIG, dtype=torch.int32, device=a_core.device))
    return cand.min(dim=1).values.to(torch.int32)
