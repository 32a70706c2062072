"""Edge-parallel views of the CSR graph and the boolean relax steps.

Counterpart of ``repro.core.bfs_steps``.  Every directed CSR entry
``(u -> v)`` is one lane of an edge-parallel relax; padding lanes carry the
sentinel ``src = dst = V``.  An optional weight plane (the SSSP kernel's
input) rides along, through chunking too.

The relax steps over ``bool [V]`` frontiers are the reference and legacy
engines' level: each active lane scatter-mins its source into
``parent[dst]``, so the winning parent is the least frontier neighbour.

The chunked view splits the (src-sorted, degree-sorted) edge array into
fixed chunks with each chunk's source-vertex range, so a top-down level
relaxes only the chunks whose range meets the frontier bitmap (the
liveness test is word-granular and conservative).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.graph_build import (
    DEFAULT_MAX_WEIGHT, CSRGraph, csr_to_edge_arrays, edge_weights,
)

DEFAULT_CHUNKS = 64


@dataclass
class EdgeView:
    """Edge-parallel view of a CSR graph (static shapes)."""

    src: torch.Tensor    # [E_pad] int32 (sentinel V on padding)
    dst: torch.Tensor    # [E_pad] int32
    valid: torch.Tensor  # [E_pad] bool
    num_vertices: int
    # [E_pad] int64 holding the uint32 weights (0 on padding); None for BFS
    weight: Optional[torch.Tensor] = None


def edge_view(g: CSRGraph) -> EdgeView:
    s, d, valid = csr_to_edge_arrays(g)
    v = g.num_vertices
    return EdgeView(torch.where(valid, s, v), torch.where(valid, d, v), valid, v)


def with_edge_weights(ev: EdgeView, *, seed: int = 0,
                      max_weight: int | None = None) -> EdgeView:
    """The same view with the deterministic symmetric weight plane of
    :func:`graph_build.edge_weights` attached."""
    w = edge_weights(ev.src, ev.dst, ev.valid, seed=seed,
                     max_weight=(DEFAULT_MAX_WEIGHT if max_weight is None
                                 else max_weight))
    return EdgeView(ev.src, ev.dst, ev.valid, ev.num_vertices, w)


def masked_relax_step(ev: EdgeView, parent: torch.Tensor, frontier: torch.Tensor,
                      visited: torch.Tensor, edge_mask: Optional[torch.Tensor]):
    """Relax the valid edges (``edge_mask`` restricts them further) whose
    source is in ``frontier`` and destination not ``visited``.

    ``parent`` is ``[V+1]`` int32 with the sentinel ``V``; returns
    ``(new_parent, next_frontier)``.  Inactive lanes scatter the sentinel
    into their own destination rather than into slot ``V``: every parent
    entry is at most ``V``, so the result is the JAX step's.
    """
    v = ev.num_vertices
    f_ext = torch.cat([frontier, frontier.new_zeros(1)])
    vis_ext = torch.cat([visited, visited.new_ones(1)])
    src, dst = ev.src.long(), ev.dst.long()
    active = ev.valid & f_ext[src] & ~vis_ext[dst]
    if edge_mask is not None:
        active &= edge_mask
    cand = torch.where(active, ev.src, v)
    new_parent = parent.scatter_reduce(0, dst, cand, "amin", include_self=True)
    return new_parent, (new_parent[:v] != v) & ~visited


def relax_step(ev: EdgeView, parent: torch.Tensor, frontier: torch.Tensor,
               visited: torch.Tensor):
    """One level: relax every edge whose source is in the frontier."""
    return masked_relax_step(ev, parent, frontier, visited, None)


def frontier_edge_count(degree: torch.Tensor, frontier: torch.Tensor) -> torch.Tensor:
    """Edges incident to the frontier: the m_f of the direction switch (int32)."""
    return torch.where(frontier, degree, 0).sum().to(torch.int32)


def unvisited_edge_count(degree: torch.Tensor, visited: torch.Tensor) -> torch.Tensor:
    return torch.where(visited, 0, degree).sum().to(torch.int32)


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
    weight: Optional[torch.Tensor] = None  # [n_chunks, chunk_size] int64


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
    weight = (None if ev.weight is None
              else pad1(ev.weight, (0, pad)).reshape(n_chunks, chunk_size))
    return ChunkedEdgeView(src, dst, valid, src_lo, src_hi, v, n_chunks,
                           chunk_size, weight)


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
