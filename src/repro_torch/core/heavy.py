"""Paper technique T2b, the dense heavy-vertex core, and the bitmap helpers.

Counterpart of ``repro.core.heavy``.  After the degree sort the K heaviest
vertices form a near-dense corner of the adjacency matrix, packed as a
Boolean bitmap ``a_core [K, K/32]`` (int32 bit-view of uint32 words) that
the ``core_spmv`` kernel scans on every bottom-up level.  Core-row edges
that leave the core stay in edge form (the halo).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.graph_build import CSRGraph, csr_to_edge_arrays
from repro_torch.kernels.bitmap_ops import WORDS_PER_TILE as BITMAP_TILE_WORDS
from repro_torch.kernels.ref import to_u64, wrap_i32

# K is padded so a core row is a whole number of 4096-bit (128-word) tiles.
CORE_ALIGN = 4096
# The core is built a block of rows at a time, each block's temporaries
# within about this many bytes beside the int32 result (19.3 GB at scale 23).
CORE_BLOCK_BYTES = 1 << 30
# A block's bytes a core word (its int64 word, then wrap_i32's bool and two
# int64 temporaries) and a CSR entry (at most about 41 B of int64 indices,
# bits and masks live at once).
_WORD_BYTES = 25
_EDGE_BYTES = 48


@dataclass
class HeavyCore:
    """Dense heavy-vertex core + sparse halo."""

    a_core: torch.Tensor      # [K, K//32] int32 bit-view — packed adjacency
    k: int                    # padded heavy-prefix size (multiple of 4096)
    k_heavy: torch.Tensor     # [] int32 — true number of heavy vertices
    threshold: int            # degree threshold D (paper: 100)
    halo_src: torch.Tensor    # [E_pad] int32 (sentinel V when invalid)
    halo_dst: torch.Tensor    # [E_pad] int32
    halo_valid: torch.Tensor  # [E_pad] bool
    core_nnz: torch.Tensor    # [] int32 — edges inside the core


def heavy_count(degree_sorted: torch.Tensor, threshold: int) -> torch.Tensor:
    """Number of vertices with degree >= threshold (prefix length after sort)."""
    return (degree_sorted >= threshold).sum().to(torch.int32)


def pad_k(k_heavy: int, v: int) -> int:
    """Pad the heavy prefix length up to the core alignment."""
    k = max(CORE_ALIGN, ((int(k_heavy) + CORE_ALIGN - 1) // CORE_ALIGN) * CORE_ALIGN)
    return min(k, max(CORE_ALIGN, (v // CORE_ALIGN) * CORE_ALIGN))


def core_blocks(row_offsets, k: int, block_bytes: int) -> list:
    """Row bounds ``[0, r1, r2, ..., k]`` of the core's build blocks.

    ``row_offsets`` holds the CSR's first ``k + 1`` row offsets (on the
    host).  A block's rows cost ``_WORD_BYTES`` a core word and
    ``_EDGE_BYTES`` a CSR entry of theirs while it is built; each block takes
    as many rows as fit ``block_bytes``, and at least one.
    """
    words = k // 32
    ro = np.asarray(row_offsets, dtype=np.int64)[: k + 1]
    cost = np.concatenate([[0], np.cumsum(words * _WORD_BYTES + np.diff(ro) * _EDGE_BYTES)])
    bounds = [0]
    while bounds[-1] < k:
        r0 = bounds[-1]
        r1 = int(np.searchsorted(cost, cost[r0] + block_bytes, side="right")) - 1
        bounds.append(min(k, max(r1, r0 + 1)))
    return bounds


def _build_core(src, dst, valid, row_offsets, k: int, block_bytes: int) -> torch.Tensor:
    """Bit-scatter the core edges into ``[K, K/32]`` words, a block of rows
    at a time.

    The core's rows ``[r0, r1)`` are CSR rows, so their entries are the
    slice ``row_offsets[r0]:row_offsets[r1]`` of ``(src, dst, valid)``.  The
    CSR is deduped, so every (src, dst) bit is set once and an integer
    ``index_add_`` on a block's int64 words is a bitwise OR of disjoint
    bits; the block is wrapped to int32 into its rows of the result.  The
    blocks' bounds (:func:`core_blocks`, within ``block_bytes``) come from
    one readback of the first ``K + 1`` row offsets; rows past ``V`` (a core
    padded beyond a tiny graph) are empty.  A block's word offsets count
    from its first row, in int64; the whole core's ``K * K/32`` words pass
    2^32 at scale 23.
    """
    words = k // 32
    ro = row_offsets[: k + 1].cpu().numpy()
    ro = np.pad(ro, (0, k + 1 - len(ro)), mode="edge")
    bounds = core_blocks(ro, k, block_bytes)
    tracing.count("build.core_words", k * words)
    tracing.count("build.core_blocks", len(bounds) - 1)
    a_core = torch.empty((k, words), dtype=torch.int32, device=src.device)
    for r0, r1 in zip(bounds, bounds[1:]):
        lo, hi = int(ro[r0]), int(ro[r1])
        n = (r1 - r0) * words
        d = dst[lo:hi].to(torch.int64)
        in_core = valid[lo:hi] & (d < k)
        word_idx = torch.where(in_core, (src[lo:hi].to(torch.int64) - r0) * words + d // 32, n)
        bit = torch.where(in_core, torch.ones_like(d) << (d % 32), 0)
        del d, in_core
        flat = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
        flat.index_add_(0, word_idx, bit)
        del word_idx, bit
        a_core[r0:r1] = wrap_i32(flat[:-1]).view(r1 - r0, words)
    return a_core


def core_from_bitmap(a_core: torch.Tensor, k_heavy: torch.Tensor, threshold: int,
                     src, dst, valid, num_vertices: int) -> HeavyCore:
    """The HeavyCore of a packed core ``a_core [K, K/32]`` over the edge
    arrays ``(src, dst, valid)``: the halo split and the core edge count
    follow from the edges and K."""
    k = int(a_core.shape[0])
    is_halo = valid & (src < k) & (dst >= k)
    return HeavyCore(
        a_core=a_core, k=k, k_heavy=k_heavy, threshold=threshold,
        halo_src=torch.where(is_halo, src, num_vertices).to(torch.int32),
        halo_dst=torch.where(is_halo, dst, num_vertices).to(torch.int32),
        halo_valid=is_halo,
        core_nnz=(valid & (src < k) & (dst < k)).sum().to(torch.int32),
    )


def build_heavy_core(g: CSRGraph, threshold: int = 100) -> HeavyCore:
    """Extract the dense core of a *degree-sorted* CSR graph."""
    src, dst, valid = csr_to_edge_arrays(g)
    k_heavy = heavy_count(g.degree, threshold)
    k = pad_k(int(k_heavy), g.num_vertices)
    a_core = _build_core(src, dst, valid, g.row_offsets, k, CORE_BLOCK_BYTES)
    return core_from_bitmap(a_core, k_heavy, threshold, src, dst, valid, g.num_vertices)


# ---------------------------------------------------------------------------
# Bitmap helpers (int32 bit-views of uint32 words, LSB-first bit order).
# ---------------------------------------------------------------------------

def bitmap_words(n_bits: int) -> int:
    return (n_bits + 31) // 32


def padded_bitmap_words(n_bits: int) -> int:
    """Words for an ``n_bits`` bitmap aligned to the frontier_update tile."""
    words = bitmap_words(n_bits)
    return -(-words // BITMAP_TILE_WORDS) * BITMAP_TILE_WORDS


def pack_bitmap(mask: torch.Tensor, n_words: int | None = None) -> torch.Tensor:
    """bool [N] -> int32 [n_words or ceil(N/32)]; bit i of word j is
    mask[32 j + i], and positions beyond N are zero.  Words with bit 31
    set are built in int64 and wrapped to the same int32 bits."""
    n = mask.shape[0]
    w = n_words if n_words is not None else bitmap_words(n)
    pad = w * 32 - n
    m = torch.nn.functional.pad(mask, (0, pad)) if pad else mask
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return wrap_i32((m.reshape(w, 32).to(torch.int64) << shifts).sum(dim=1))


def unpack_bitmap(bm: torch.Tensor, n_bits: int) -> torch.Tensor:
    """int32 [W] -> bool [n_bits]."""
    shifts = torch.arange(32, dtype=torch.int64, device=bm.device)
    bits = (to_u64(bm)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n_bits].to(torch.bool)


def testbit(bm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather bit ``idx`` from a packed bitmap (idx any integer tensor).

    The word index is clamped into the bitmap, as JAX clamps an
    out-of-bounds gather: padding edges carry the sentinel ``V``, and when
    ``V`` is a multiple of 32,768 their word ``V // 32`` is one past the
    end.  Callers mask such lanes; the clamp only keeps the gather legal.
    """
    idx = idx.to(torch.int64)
    word = bm[(idx // 32).clamp(0, bm.shape[0] - 1)]
    return ((word >> (idx % 32)) & 1).to(torch.bool)
