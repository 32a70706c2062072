"""Edge-parallel views of the CSR graph and the boolean relax steps.

Counterpart of ``repro.core.bfs_steps``.  Every directed CSR entry
``(u -> v)`` is one lane of an edge-parallel relax; padding lanes carry the
sentinel ``src = dst = V``.  An optional weight plane (the SSSP kernel's
input) rides along, through chunking too.

The relax steps over ``bool [V]`` frontiers are the reference and legacy
engines' level: each active lane scatter-mins its source into
``parent[dst]``, so the winning parent is the least frontier neighbour.

The chunked view is the JAX package's layout: the (src-sorted,
degree-sorted) edge array split into fixed chunks with each chunk's
source-vertex range, so a top-down level relaxes only the chunks whose range
meets the frontier bitmap (the liveness test is word-granular and
conservative).  The vertex-sharded engine relaxes by chunks; one device does
not: its engines walk :class:`EdgeRows`, which keeps of the chunks only their
source ranges, for the ``scanned_chunks`` stat.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.graph_build import (
    DEFAULT_MAX_WEIGHT, CSRGraph, csr_to_edge_arrays, edge_weights,
)
from repro_torch.core.heavy import HeavyCore
from repro_torch.kernels.ref import chunk_range_mask, wrap_i32

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
    # the weight plane holds float32 bit patterns (Kernel 3's reals in
    # [0, 1)) in place of integers
    real_weights: bool = False


def edge_view(g: CSRGraph) -> EdgeView:
    s, d, valid = csr_to_edge_arrays(g)
    v = g.num_vertices
    return EdgeView(torch.where(valid, s, v), torch.where(valid, d, v), valid, v)


def with_edge_weights(ev: EdgeView, *, seed: int = 0,
                      max_weight: int | None = None, real: bool = False) -> EdgeView:
    """The same view with the deterministic symmetric weight plane of
    :func:`graph_build.edge_weights` attached (``real``: the float32
    reals in [0, 1))."""
    w = edge_weights(ev.src, ev.dst, ev.valid, seed=seed,
                     max_weight=(DEFAULT_MAX_WEIGHT if max_weight is None
                                 else max_weight), real=real)
    return EdgeView(ev.src, ev.dst, ev.valid, ev.num_vertices, w, real)


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


def chunk_frontier_mask(chunks: ChunkedEdgeView, frontier_bm: torch.Tensor) -> torch.Tensor:
    """bool [n_chunks]: chunk source range intersects the frontier bitmap."""
    return chunk_range_mask(chunks.src_lo, chunks.src_hi, frontier_bm)


@dataclass
class EdgeRows:
    """The rows of a source-sorted edge view, as the single-device engines'
    relax kernels walk them: vertex u's entries are ``[row_start[u],
    row_start[u] + degree[u])`` of ``dst`` (and ``weight``), and the first
    ``core_deg[u]`` of a core row (u below ``len(core_deg)``) lie inside the
    dense core.  ``src_lo`` / ``src_hi`` are the source ranges of the plan's
    chunks, those of :func:`chunk_edge_view`, which a top-down BFS level
    tests against the frontier for its ``scanned_chunks`` stat.  Every field
    is a tensor (or None), so the rows move to a device field by field."""

    row_start: torch.Tensor          # [V] int64
    dst: torch.Tensor                # [E_pad] int32: the view's own
    # [E_pad] int32 bits of the uint32 weights, float32 for real weights; None for BFS
    weight: Optional[torch.Tensor]
    core_deg: torch.Tensor           # [min(K, V)] int32; empty without a core
    src_lo: torch.Tensor             # [n_chunks] int32 (V when the chunk is empty)
    src_hi: torch.Tensor             # [n_chunks] int32 (-1 when the chunk is empty)

    @property
    def n_chunks(self) -> int:
        return self.src_lo.shape[0]


def _row_weights(ev: EdgeView) -> torch.Tensor:
    """The rows' weight plane: the weights' 32 bits as int32, viewed as
    float32 for real weights, so the rows carry the weight kind."""
    w = wrap_i32(ev.weight).contiguous()
    return w.view(torch.float32) if ev.real_weights else w


def edge_rows(ev: EdgeView, degree: torch.Tensor, core: HeavyCore | None = None,
              n_chunks: int = DEFAULT_CHUNKS, *, weighted: bool = False) -> EdgeRows:
    """The rows of ``ev`` (set-up, once a plan): the row offsets are the
    exclusive cumulative sum of ``degree``.  Raises unless the valid entries
    are the first ``sum(degree)``, padding only after them, and their sources
    run through the vertices in order, ``degree[u]`` entries each (the layout
    ``build_csr`` gives).  Without ``weighted`` each row must also ascend: the
    BFS bottom-up walk stops at a row's first frontier neighbour, which must be
    its least; the SSSP relax (``weighted``, the weights' 32 bits kept in an
    int32 plane) reads whole rows.  Chunk c of ``ceil(E_pad / n_chunks)``
    entries holds the valid entries ``[c * size, min((c + 1) * size, n))``,
    so under this layout its source range is the sources of its first and
    last: two gathers a chunk, and no chunk is built."""
    if weighted and ev.weight is None:
        raise ValueError("SSSP needs a weighted EdgeView")
    v = ev.num_vertices
    if degree.shape != (v,):
        raise ValueError(f"degree has shape {tuple(degree.shape)}, the view {v} vertices")
    ends = torch.cumsum(degree, 0, dtype=torch.int64)
    n = int(ends[-1]) if v else 0
    ids = torch.arange(v, dtype=torch.int32, device=degree.device)
    src, dst = ev.src[:n], ev.dst[:n]
    if (n > ev.valid.shape[0] or not bool(ev.valid[:n].all())
            or bool(ev.valid[n:].any())
            or not torch.equal(src, torch.repeat_interleave(ids, degree, output_size=n))
            or (not weighted
                and bool(((dst[1:] < dst[:-1]) & (src[1:] == src[:-1])).any()))):
        raise ValueError("the single-device engines need a source-sorted edge view with "
                         "degree[u] entries for each vertex u in order, "
                         + ("" if weighted else "each row ascending, ")
                         + "and the padding after them (the layout build_csr gives)")
    kk = 0 if core is None else min(core.k, v)
    in_core = (src < kk) & (dst < kk)
    core_deg = torch.bincount(src[in_core].to(torch.int64), minlength=kk)[:kk]
    size = -(-ev.src.shape[0] // n_chunks)
    first = torch.arange(n_chunks, dtype=torch.int64, device=degree.device) * size
    live = first < n
    src_lo = torch.full((n_chunks,), v, dtype=torch.int32, device=degree.device)
    src_hi = torch.full((n_chunks,), -1, dtype=torch.int32, device=degree.device)
    if n:
        src_lo = torch.where(live, src[first.clamp(max=n - 1)], src_lo)
        src_hi = torch.where(live, src[(first + size).clamp(max=n) - 1], src_hi)
    return EdgeRows(row_start=ends - degree, dst=ev.dst.contiguous(),
                    weight=_row_weights(ev) if weighted else None,
                    core_deg=core_deg.to(torch.int32), src_lo=src_lo, src_hi=src_hi)
