"""Paper technique T2b, the dense heavy-vertex core, and the bitmap helpers.

Counterpart of ``repro.core.heavy``.  After the degree sort the K heaviest
vertices form a near-dense corner of the adjacency matrix, packed as a
Boolean bitmap ``a_core [K, K/32]`` (int32 bit-view of uint32 words) that
the ``core_spmv`` kernel scans on every bottom-up level.  Core-row edges
that leave the core stay in edge form (the halo).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.graph_build import CSRGraph, csr_to_edge_arrays
from repro_torch.kernels.bitmap_ops import WORDS_PER_TILE as BITMAP_TILE_WORDS
from repro_torch.kernels.ref import to_u64, wrap_i32

# K is padded so a core row is a whole number of 4096-bit (128-word) tiles.
CORE_ALIGN = 4096


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


def _build_core(src, dst, valid, k: int) -> torch.Tensor:
    """Bit-scatter the core edges into ``[K, K/32]`` words.

    The CSR is deduped, so every (src, dst) bit is set once and an integer
    ``index_add_`` on int64 words is a bitwise OR of disjoint bits.  The
    flat word index is int64: ``src * words`` passes 2^31 once K > ~2.6e5.
    """
    words = k // 32
    in_core = valid & (src < k) & (dst < k)
    word_idx = torch.where(in_core, src.to(torch.int64) * words + dst.to(torch.int64) // 32,
                           k * words)
    bit = torch.where(in_core, torch.ones_like(word_idx) << (dst.to(torch.int64) % 32), 0)
    flat = torch.zeros(k * words + 1, dtype=torch.int64, device=src.device)
    flat.index_add_(0, word_idx, bit)
    return wrap_i32(flat[:-1]).reshape(k, words)


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
    return core_from_bitmap(_build_core(src, dst, valid, k), k_heavy, threshold,
                            src, dst, valid, g.num_vertices)


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
