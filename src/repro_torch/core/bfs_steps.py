"""Edge-parallel views of the CSR graph for the BFS engine.

Counterpart of the edge views in ``repro.core.bfs_steps``.  Every directed
CSR entry ``(u -> v)`` is one lane of an edge-parallel relax; padding lanes
carry the sentinel ``src = dst = V``.

The chunked view splits the (src-sorted, degree-sorted) edge array into
fixed chunks with each chunk's source-vertex range, so a top-down level
relaxes only the chunks whose range meets the frontier bitmap (the
liveness test is word-granular and conservative).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.graph_build import CSRGraph, csr_to_edge_arrays

DEFAULT_CHUNKS = 64


@dataclass
class EdgeView:
    """Edge-parallel view of a CSR graph (static shapes)."""

    src: torch.Tensor    # [E_pad] int32 (sentinel V on padding)
    dst: torch.Tensor    # [E_pad] int32
    valid: torch.Tensor  # [E_pad] bool
    num_vertices: int


def edge_view(g: CSRGraph) -> EdgeView:
    s, d, valid = csr_to_edge_arrays(g)
    v = g.num_vertices
    return EdgeView(torch.where(valid, s, v), torch.where(valid, d, v), valid, v)


@dataclass
class ChunkedEdgeView:
    """``EdgeView`` re-laid-out as [n_chunks, chunk_size] with src ranges."""

    src: torch.Tensor      # [n_chunks, chunk_size] int32 (sentinel V on padding)
    dst: torch.Tensor      # [n_chunks, chunk_size] int32
    valid: torch.Tensor    # [n_chunks, chunk_size] bool
    src_lo: torch.Tensor   # [n_chunks] int32 — min valid src (V when chunk empty)
    src_hi: torch.Tensor   # [n_chunks] int32 — max valid src (-1 when chunk empty)
    num_vertices: int
    n_chunks: int
    chunk_size: int


def chunk_edge_view(ev: EdgeView, n_chunks: int = DEFAULT_CHUNKS) -> ChunkedEdgeView:
    """Split the (src-sorted) edge arrays into ``n_chunks`` fixed chunks."""
    v = ev.num_vertices
    e_pad = ev.src.shape[0]
    chunk_size = -(-e_pad // n_chunks)  # ceil
    pad = n_chunks * chunk_size - e_pad
    pad1 = torch.nn.functional.pad
    src = pad1(ev.src, (0, pad), value=v).reshape(n_chunks, chunk_size)
    dst = pad1(ev.dst, (0, pad), value=v).reshape(n_chunks, chunk_size)
    valid = pad1(ev.valid, (0, pad)).reshape(n_chunks, chunk_size)
    src_lo = torch.where(valid, src, v).amin(dim=1).to(torch.int32)
    src_hi = torch.where(valid, src, -1).amax(dim=1).to(torch.int32)
    return ChunkedEdgeView(src, dst, valid, src_lo, src_hi, v, n_chunks, chunk_size)


def chunk_range_mask(src_lo: torch.Tensor, src_hi: torch.Tensor,
                     frontier_bm: torch.Tensor) -> torch.Tensor:
    """bool per chunk: source range ``[src_lo, src_hi]`` meets the frontier.

    Word-granular (conservative superset) test: a chunk is live when any
    bitmap word overlapping its range is nonzero.
    """
    w = frontier_bm.shape[0]
    word_nz = (frontier_bm != 0).to(torch.int32)
    cum = torch.cat([torch.zeros(1, dtype=torch.int32, device=word_nz.device),
                     torch.cumsum(word_nz, 0).to(torch.int32)])
    lo_w = (src_lo // 32).clamp(0, w - 1).long()
    hi_w = (src_hi // 32).clamp(0, w - 1).long()
    nonempty = src_hi >= src_lo
    return nonempty & ((cum[hi_w + 1] - cum[lo_w]) > 0)


def chunk_frontier_mask(chunks: ChunkedEdgeView, frontier_bm: torch.Tensor) -> torch.Tensor:
    """bool [n_chunks]: chunk source range intersects the frontier bitmap."""
    return chunk_range_mask(chunks.src_lo, chunks.src_hi, frontier_bm)
