"""Graph construction: edge list -> static-shape symmetric CSR (Graph500 step 2).

Counterpart of ``repro.core.graph_build``: symmetrize, drop self loops,
sort by (src, dst), dedupe, re-sort so the invalid slots (sentinel ``V``)
sit at the tail, then degree and row offsets.  Every array keeps the static
length ``2 * M``.  The (src, dst) lexsort is one stable sort of the int64
key ``src * (V + 1) + dst``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.kronecker import EdgeList


@dataclass
class CSRGraph:
    """Symmetric static-shape CSR; slots ``>= nnz`` hold the sentinel ``V``."""

    row_offsets: torch.Tensor   # [V+1] int32
    col_indices: torch.Tensor   # [E_pad] int32 (sentinel V in padding)
    edge_valid: torch.Tensor    # [E_pad] bool
    degree: torch.Tensor        # [V] int32
    nnz: torch.Tensor           # [] int32 — directed entries (2x undirected)
    num_vertices: int

    @property
    def padded_edges(self) -> int:
        return int(self.col_indices.shape[0])

    def edge_sources(self) -> torch.Tensor:
        """Per-entry source ids from row_offsets (searchsorted); V on padding."""
        e = torch.arange(self.padded_edges, dtype=torch.int32,
                         device=self.row_offsets.device)
        return (torch.searchsorted(self.row_offsets, e, right=True,
                                   out_int32=True) - 1)


def _lexsort(s: torch.Tensor, d: torch.Tensor, v: int) -> torch.Tensor:
    key = s.to(torch.int64) * (v + 1) + d.to(torch.int64)
    return torch.sort(key, stable=True).indices


def build_csr(edges: EdgeList) -> CSRGraph:
    """Graph500 step 2: construct the symmetric CSR from the edge list."""
    v = edges.num_vertices
    s = torch.cat([edges.src, edges.dst])
    d = torch.cat([edges.dst, edges.src])
    self_loop = s == d
    s = torch.where(self_loop, v, s)
    d = torch.where(self_loop, v, d)
    order = _lexsort(s, d, v)
    s, d = s[order], d[order]
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=s.device),
                     (s[1:] == s[:-1]) & (d[1:] == d[:-1])])
    valid = (s < v) & ~dup
    s = torch.where(valid, s, v)
    d = torch.where(valid, d, v)
    # re-sort so invalidated duplicates move to the tail, keeping CSR dense.
    order2 = _lexsort(s, d, v)
    s, d, valid = s[order2], d[order2], valid[order2]
    degree = torch.bincount(s[valid].to(torch.int64), minlength=v)[:v].to(torch.int32)
    row_offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=s.device),
                             torch.cumsum(degree, 0).to(torch.int32)])
    return CSRGraph(
        row_offsets=row_offsets, col_indices=d.to(torch.int32),
        edge_valid=valid, degree=degree, nnz=row_offsets[-1].clone(),
        num_vertices=v,
    )


def csr_to_edge_arrays(g: CSRGraph):
    """(src, dst, valid) per directed CSR entry — the edge-parallel view."""
    return g.edge_sources(), g.col_indices, g.edge_valid


# ---------------------------------------------------------------------------
# Deterministic edge weights (the SSSP kernel's input).
#
# The weight is a pure function of the unordered endpoint pair, so
# w(u, v) == w(v, u) without an undirected edge list: a 32-bit finalizer
# hash of the canonical (min, max) pair, bit-identical to the JAX
# package's ``edge_weights``.  torch has no uint32 arithmetic, so the
# words ride in int64 holding [0, 2^32): each 32 x 32-bit product is split
# into 16-bit halves (every partial product < 2^48) and masked back to 32
# bits, and the right shifts act on non-negative values.
# ---------------------------------------------------------------------------

DEFAULT_MAX_WEIGHT = 255
_U32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for int64 ``h`` in [0, 2^32) and a 32-bit ``c``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer (lowbias32-style avalanche) on int64 words."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def edge_weights(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor, *,
                 seed: int = 0, max_weight: int = DEFAULT_MAX_WEIGHT,
                 real: bool = False) -> torch.Tensor:
    """int64 weight in ``[1, max_weight]`` per directed edge entry, 0 on
    invalid slots; symmetric and deterministic in ``seed``.  The values
    are the JAX package's uint32 weights.

    With ``real``, the Graph500 specification's Kernel 3 weights instead:
    uniform reals in [0, 1) at float32's 24 bits, ``(h >> 8) * 2^-24`` of
    the same hash ``h`` (exact in float32; 0 on about one entry in 2^24),
    held as the float32 bit patterns (``max_weight`` is not read).  The
    specification draws them from its random number generator; the hash
    stands in for it."""
    if max_weight < 1:
        raise ValueError(f"max_weight must be >= 1, got {max_weight}")
    s = src.to(torch.int64) & _U32
    d = dst.to(torch.int64) & _U32
    a = torch.minimum(s, d)
    b = torch.maximum(s, d)
    h = _mix32((_mul32(a, 0x9E3779B9) + (int(seed) & _U32)) & _U32)
    h = _mix32(h ^ _mul32(b, 0x85EBCA6B))
    if real:
        w = ((h >> 8).to(torch.float32) * 2.0 ** -24).view(torch.int32).to(torch.int64)
    else:
        w = 1 + h % int(max_weight)
    return torch.where(valid, w, 0)
