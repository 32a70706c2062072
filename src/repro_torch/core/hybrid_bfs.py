"""Direction-optimizing hybrid BFS (paper §2.1): the bitmap-resident engine.

Counterpart of the ``bitmap`` engine of ``repro.core.hybrid_bfs``
(``_run_bitmap_impl``).  Switching policy, paper eq. (1)/(2)::

    top-down  -> bottom-up  when |in| > ThrV1 = (|V| - |vis|) / alpha
    bottom-up -> top-down   when |in| < ThrV2 = |V| / beta

with ``|V|`` the active (non-isolated) vertices.  ``frontier`` and
``visited`` live as packed int32 bit-views ``[W]`` for the whole traversal;
every level ends in the fused ``frontier_update`` kernel, and a bottom-up
level starts with the ``core_spmv`` kernel over the dense heavy core.

JAX's ``lax.while_loop`` becomes a host loop that synchronises once per
level, on the popcount the epilogue kernel returns; the direction switch
is then decided on the host.  ``lax.cond`` over the edge chunks becomes a
gather of the live chunks (a top-down level also reads their indices back).
The outputs (parent, level and every stats trace) are bitwise equal to the
JAX engine's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.bfs_steps import ChunkedEdgeView, chunk_frontier_mask
from repro_torch.core.heavy import HeavyCore, pack_bitmap, padded_bitmap_words, testbit
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import BIG, popcount_u32

MAX_LEVELS = 64
TOP_DOWN, BOTTOM_UP = 0, 1

ENGINES = ("reference", "legacy", "bitmap")

#: All in-loop sentinel bits passing (BFSStats.sentinel).
SENTINEL_OK = 7


def _switch_direction(direction: int, in_count: int, vis_count: int,
                      n_active: int, alpha: float, beta: float) -> int:
    """Paper eq. (1)/(2) hybrid switch.

    The thresholds divide in float32 and truncate to int32, exactly as the
    JAX engine does: float64 can move a threshold across an integer and
    flip the level at which the direction switches.
    """
    thrv1 = int(np.float32(n_active - vis_count) / np.float32(alpha))
    thrv2 = int(np.float32(n_active) / np.float32(beta))
    if direction == TOP_DOWN and in_count > thrv1:
        return BOTTOM_UP
    if direction == BOTTOM_UP and in_count < thrv2:
        return TOP_DOWN
    return direction


class BFSStats(NamedTuple):
    direction: torch.Tensor       # [MAX_LEVELS] int32 (-1 unused)
    frontier_size: torch.Tensor   # [MAX_LEVELS] int32
    scanned_edges: torch.Tensor   # [MAX_LEVELS] int32 — work estimate per level
    levels: torch.Tensor          # [] int32
    scanned_chunks: torch.Tensor  # [MAX_LEVELS] int32 — edge chunks relaxed (-1 n/a)
    total_chunks: torch.Tensor    # [] int32
    # per-level bitmask, -1 for unused levels: bit0 = delta conservation,
    # bit1 = frontier ∩ visited = ∅, bit2 = level within bound.
    sentinel: Optional[torch.Tensor] = None


class BFSResult(NamedTuple):
    parent: torch.Tensor  # [V] int32, -1 = unvisited, parent[root] == root
    level: torch.Tensor   # [V] int32, -1 = unvisited
    stats: Optional[BFSStats]


def bottom_up_tail(chunks: ChunkedEdgeView, core: HeavyCore | None):
    """(src, dst) of the valid edges a bottom-up level relaxes after the
    core step: every valid edge but the core-to-core ones.

    Compacted once per graph.  The JAX engine masks the same edges in
    place; a scatter-min gives the same parents either way.
    """
    src = chunks.src.reshape(-1)
    dst = chunks.dst.reshape(-1)
    keep = chunks.valid.reshape(-1)
    if core is not None:
        keep = keep & ~((src < core.k) & (dst < core.k))
    return src[keep], dst[keep]


def _core_bottom_up_resident(core: HeavyCore, frontier_bm, visited_bm,
                             parent_ext, v: int) -> None:
    """Dense-core kernel step on the resident frontier bitmap, in place.

    Row i's candidate parent lands on vertex i itself, so the JAX
    scatter-min over distinct rows is an elementwise min on the prefix.
    Rows at or past ``V`` (a core padded beyond a tiny graph) have no edges
    and never win.
    """
    k = core.k
    cand = kops.core_spmv(core.a_core, frontier_bm[: k // 32])  # int32 [K]
    kk = min(k, v)
    rows = torch.arange(kk, dtype=torch.int32, device=cand.device)
    won = (cand[:kk] < BIG) & ~testbit(visited_bm, rows)
    prefix = parent_ext[:kk]
    prefix.copy_(torch.minimum(prefix, torch.where(won, cand[:kk], v)))


def _relax_edges(sc, dc, vc, frontier_bm, visited_bm, parent_ext, v: int) -> None:
    """One edge-parallel relax pass in bitmap space, in place.

    Lanes that are not active scatter the sentinel ``v`` into their own
    destination rather than into the scratch slot ``V``: every parent entry
    is at most ``v``, so the result is the JAX engine's, and the atomics do
    not all pile onto one address.  ``vc`` None means every lane is valid.
    """
    active = testbit(frontier_bm, sc) & ~testbit(visited_bm, dc)
    if vc is not None:
        active &= vc
    cand = torch.where(active, sc, v)
    parent_ext.scatter_reduce_(0, dc.long(), cand, "amin", include_self=True)


def _run_bitmap_impl(chunks: ChunkedEdgeView, degree: torch.Tensor,
                     n_active: int, root: int, core: HeavyCore | None, *,
                     alpha: float, beta: float, max_levels: int,
                     tail) -> BFSResult:
    """One bitmap-resident traversal from ``root`` (host loop, one sync a
    level).  ``tail`` is :func:`bottom_up_tail` of the graph."""
    v = chunks.num_vertices
    dev = degree.device
    i32 = torch.int32
    w = padded_bitmap_words(v)
    root = int(root)
    tail_src, tail_dst = tail
    nnz_total = degree.sum().to(i32)

    parent_ext = torch.full((v + 1,), v, dtype=i32, device=dev)
    parent_ext[root] = root
    level = torch.full((v,), -1, dtype=i32, device=dev)
    level[root] = 0
    frontier_bm = torch.zeros(w, dtype=i32, device=dev)
    bit = 1 << (root % 32)
    frontier_bm[root // 32] = bit - 2**32 if bit >= 2**31 else bit
    visited_bm = frontier_bm.clone()
    # The epilogue writes each level's (frontier, visited) into the pair the
    # previous level read from, so the loop allocates no bitmaps.
    pairs = [(frontier_bm, visited_bm),
             (torch.empty_like(frontier_bm), torch.empty_like(visited_bm))]
    count = torch.empty((), dtype=i32, device=dev)
    m_f = degree[root].to(i32)
    deg_vis = m_f.clone()

    stats_dir = torch.full((max_levels,), -1, dtype=i32, device=dev)
    stats_fs = torch.zeros(max_levels, dtype=i32, device=dev)
    stats_se = torch.zeros(max_levels, dtype=i32, device=dev)
    stats_ch = torch.full((max_levels,), -1, dtype=i32, device=dev)
    stats_ok = torch.full((max_levels,), -1, dtype=i32, device=dev)

    in_count, vis_count = 1, 1
    lvl, direction = 0, TOP_DOWN
    while lvl < max_levels:
        if lvl > 0:
            in_count = int(count)  # the level's one synchronisation
            vis_count += in_count
        if in_count == 0:
            break
        direction = _switch_direction(direction, in_count, vis_count,
                                      n_active, alpha, beta)
        unvisited = parent_ext[:v] == v
        if direction == BOTTOM_UP:
            if core is not None:
                _core_bottom_up_resident(core, frontier_bm, visited_bm,
                                         parent_ext, v)
            _relax_edges(tail_src, tail_dst, None, frontier_bm, visited_bm,
                         parent_ext, v)
            nsc = chunks.n_chunks  # full scan
        else:
            live = torch.nonzero(chunk_frontier_mask(chunks, frontier_bm)).squeeze(1)
            nsc = int(live.numel())
            _relax_edges(chunks.src[live].reshape(-1),
                         chunks.dst[live].reshape(-1),
                         chunks.valid[live].reshape(-1),
                         frontier_bm, visited_bm, parent_ext, v)

        # Epilogue: pack the newly-found delta, then the fused kernel does
        # mask / merge / popcount in one pass, into the idle pair.
        newly = (parent_ext[:v] != v) & unvisited
        found = pack_bitmap(newly, w)
        next_bm, new_visited_bm = pairs[(lvl + 1) % 2]
        kops.frontier_update(found, visited_bm, out=(next_bm, new_visited_bm, count))

        s1 = count == popcount_u32(found).sum()
        s2 = popcount_u32(next_bm & visited_bm).sum() == 0  # the old visited
        s3 = int(lvl + 1 <= max_levels)
        stats_ok[lvl] = s1.to(i32) + 2 * s2.to(i32) + 4 * s3

        level.masked_fill_(newly, lvl + 1)
        m_next = torch.where(newly, degree, 0).sum().to(i32)
        # scanned-edge estimate: TD scans frontier adjacency (m_f), BU the
        # unvisited adjacency.
        stats_se[lvl] = m_f if direction == TOP_DOWN else nnz_total - deg_vis
        stats_dir[lvl] = direction
        stats_fs[lvl] = in_count
        stats_ch[lvl] = nsc

        frontier_bm, visited_bm = next_bm, new_visited_bm
        m_f, deg_vis = m_next, deg_vis + m_next
        lvl += 1

    parent = parent_ext[:v]
    parent = torch.where(parent == v, -1, parent)
    return BFSResult(
        parent=parent, level=level,
        stats=BFSStats(
            stats_dir, stats_fs, stats_se,
            torch.tensor(lvl, dtype=i32, device=dev), stats_ch,
            torch.tensor(chunks.n_chunks, dtype=i32, device=dev), stats_ok,
        ),
    )


def _run_batch(chunks, degree, n_active, roots, core, **kw) -> BFSResult:
    """The roots one after another through the per-root engine, stacked into
    one batched result ([R, ...] leaves)."""
    results = [_run_bitmap_impl(chunks, degree, n_active, int(r), core, **kw)
               for r in roots]
    return stack_results(results)


def stack_results(results: list[BFSResult]) -> BFSResult:
    stats = BFSStats(*(torch.stack(f) for f in zip(*(r.stats for r in results))))
    return BFSResult(torch.stack([r.parent for r in results]),
                     torch.stack([r.level for r in results]), stats)
