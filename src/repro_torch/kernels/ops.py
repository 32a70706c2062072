"""Public kernel entry points, dispatched on the tensor's device.

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``, and so
does a ``meta`` tensor (no data: the dry run's shape-only steps,
``launch.dryrun``); a tensor on the card goes to the hand-written CUDA
kernel, which is built on first use and raises if it cannot be built or
launched.  There is no fallback from the card to the plain version and no
switch that routes CUDA tensors elsewhere.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (
    bfs_level, bfs_relax, bitmap_ops, cin, frontier_spmv, ref, spmv_mxu,
)
from repro_torch.kernels import sssp_relax as relax_kernel

#: device types that take the plain versions
_PLAIN = ("cpu", "meta")

#: name -> kernel object of every hand-written kernel (its ``launches``
#: counts the launches the CUDA runtime accepted).
KERNELS = {
    "frontier_update": bitmap_ops.KERNEL,
    "core_spmv": frontier_spmv.KERNEL,
    "spmv_mxu": spmv_mxu.KERNEL,
    "cin_layer": cin.KERNEL,
    "sssp_relax": relax_kernel.KERNEL,
    "bfs_relax": bfs_relax.KERNEL,
    "bfs_level_delta": bfs_level.DELTA,
    "bfs_level_stats": bfs_level.STATS,
    "bfs_live_chunks": bfs_level.CHUNKS,
    "bfs_core_merge": bfs_level.MERGE,
}


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def frontier_update(next_raw: torch.Tensor, visited: torch.Tensor, out=None):
    """Fused: next &= ~visited; visited |= next; count = popcount(next).

    ``out=(next, visited, count)`` writes into the caller's buffers (none may
    alias an input or another output) and returns them.
    """
    if next_raw.device.type in _PLAIN:
        return ref.frontier_update_ref(next_raw, visited, out=out)
    return bitmap_ops.frontier_update(next_raw, visited, out=out)


def core_spmv(a_core: torch.Tensor, frontier_bm: torch.Tensor, *,
              rows_per_tile: int = 8, words_read=None) -> torch.Tensor:
    """Bottom-up step over the dense core: min frontier neighbour per row;
    ``words_read`` (an int64 scalar, or None) gains the words of the core
    read (each row up to the group of its first hit)."""
    if a_core.device.type in _PLAIN:
        return ref.core_spmv_ref(a_core, frontier_bm, words_read)
    return frontier_spmv.core_spmv(a_core, frontier_bm, rows_per_tile=rows_per_tile,
                                   words_read=words_read)


def multi_source_spmv(a_core8: torch.Tensor, frontier8: torch.Tensor) -> torch.Tensor:
    """Batched-root Boolean SpMV: int8 [K, K] x int8 [K, R] -> int32 [K, R].

    K and R must be multiples of 128 on either device (the kernel's tiles).
    """
    spmv_mxu.check_shapes(a_core8, frontier8)
    if a_core8.device.type in _PLAIN:
        return ref.spmv_mxu_ref(a_core8, frontier8)
    return spmv_mxu.spmv_mxu(a_core8, frontier8)


def cin_layer(x0: torch.Tensor, xl: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused xDeepFM CIN layer: [B, F0, D] x [B, Fl, D] x [H, F0, Fl] -> [B, H, D].

    The kernel has no backward, so inputs that need a gradient are refused
    on every device (the plain version would differentiate where the card
    cannot): train through the einsum path, ``use_cin_kernel=False``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x0, xl, w)):
        raise ValueError("cin_layer: the CIN kernel has no backward; call it "
                         "under torch.no_grad() or torch.inference_mode()")
    if x0.device.type in _PLAIN:
        return ref.cin_layer_ref(x0, xl, w)
    return cin.cin_layer(x0, xl, w)


def sssp_relax(state: torch.Tensor, changed: torch.Tensor, front_deg: torch.Tensor,
               row_start: torch.Tensor, dst: torch.Tensor, weight: torch.Tensor) -> None:
    """One δ-stepping round's relax over the frontier's rows, in place.

    ``state`` int64 [V] holds the uint64 keys ``(dist << 32) | parent``,
    ``changed`` bool [V] gains the vertices whose distance fell,
    ``front_deg`` int32 [V] is the frontier's out-degrees (0 elsewhere),
    and vertex u's row is ``[row_start[u], row_start[u] + front_deg[u])`` of
    ``dst`` / ``weight`` (int32, the weights' uint32 bit view; float32 real
    weights take float32 distances and hops in the key's low half,
    :func:`ref.sssp_relax_ref`)."""
    if state.device.type in _PLAIN:
        return ref.sssp_relax_ref(state, changed, front_deg, row_start, dst, weight)
    return relax_kernel.sssp_relax(state, changed, front_deg, row_start, dst, weight)


def bfs_relax_top_down(frontier_bm: torch.Tensor, visited_bm: torch.Tensor,
                       degree: torch.Tensor, row_start: torch.Tensor, dst: torch.Tensor,
                       parent_ext: torch.Tensor) -> None:
    """A top-down BFS level's relax over the frontier's rows, in place.

    ``frontier_bm`` and ``visited_bm`` are int32 bitmaps, ``degree`` int32
    [V], vertex u's row ``[row_start[u], row_start[u] + degree[u])`` of
    ``dst``, and ``parent_ext`` int32 [V + 1] (sentinel V) takes each
    unvisited destination's least frontier neighbour."""
    if parent_ext.device.type in _PLAIN:
        return ref.bfs_relax_top_down_ref(frontier_bm, visited_bm, degree, row_start, dst,
                                          parent_ext)
    return bfs_relax.top_down(frontier_bm, visited_bm, degree, row_start, dst, parent_ext)


def bfs_relax_bottom_up(frontier_bm: torch.Tensor, parent_ext: torch.Tensor,
                        degree: torch.Tensor, row_start: torch.Tensor, dst: torch.Tensor,
                        core_deg: torch.Tensor, entries_read=None) -> None:
    """A bottom-up BFS level's relax, in place: each vertex still at the
    sentinel takes the first frontier vertex of its ascending row (past the
    ``core_deg[v]`` core entries of a core row v); ``entries_read`` (an
    int64 scalar, or None) gains the row entries read."""
    if parent_ext.device.type in _PLAIN:
        return ref.bfs_relax_bottom_up_ref(frontier_bm, parent_ext, degree, row_start, dst,
                                           core_deg, entries_read)
    return bfs_relax.bottom_up(frontier_bm, parent_ext, degree, row_start, dst, core_deg,
                               entries_read)


def bfs_level_delta(parent_ext: torch.Tensor, visited_bm: torch.Tensor, degree: torch.Tensor,
                    level: torch.Tensor, next_level: int, found: torch.Tensor,
                    acc: torch.Tensor) -> None:
    """A bitmap BFS level's delta, in place: the vertices with a parent
    (``parent_ext[v] != V``) that are not in ``visited_bm`` go into ``found``
    (int32 [W], every word written) and get ``next_level`` in ``level``; their
    degree sum and count land in ``acc`` (``ref.ACC_M_NEXT``,
    ``ref.ACC_FOUND``)."""
    if parent_ext.device.type in _PLAIN:
        return ref.bfs_level_delta_ref(parent_ext, visited_bm, degree, level, next_level,
                                       found, acc)
    return bfs_level.delta(parent_ext, visited_bm, degree, level, next_level, found, acc)


def bfs_level_stats(next_bm: torch.Tensor, visited_bm: torch.Tensor, count: torch.Tensor,
                    acc: torch.Tensor, stats: torch.Tensor, lvl: int, bottom_up: bool,
                    in_count: int, n_chunks: int, core_rows: int = 0,
                    unvisited=None) -> None:
    """A bitmap BFS level's stats into column ``lvl`` of ``stats`` (int32
    [ref.STATS_ROWS, max_levels], rows ``ref.STATS_*``): its direction and
    frontier size (``in_count``) from the host, its sentinels from
    ``frontier_update``'s ``next_bm`` and ``count``, the old ``visited_bm``
    and ``acc``, which moves on to the next level, its scanned edges, and a
    bottom-up level's ``n_chunks``.  With ``unvisited`` (an int32 scalar),
    the rows i < ``core_rows`` in neither bitmap are counted into it."""
    if next_bm.device.type in _PLAIN:
        return ref.bfs_level_stats_ref(next_bm, visited_bm, count, acc, stats, lvl,
                                       bottom_up, in_count, n_chunks, core_rows, unvisited)
    return bfs_level.stats(next_bm, visited_bm, count, acc, stats, lvl, bottom_up, in_count,
                           n_chunks, core_rows, unvisited)


def bfs_live_chunks(frontier_bm: torch.Tensor, src_lo: torch.Tensor, src_hi: torch.Tensor,
                    stats: torch.Tensor, lvl: int) -> None:
    """A top-down level's ``scanned_chunks``: the chunks whose source range
    meets ``frontier_bm`` word by word, counted into ``stats[ref.STATS_CH,
    lvl]``."""
    if frontier_bm.device.type in _PLAIN:
        return ref.bfs_live_chunks_ref(frontier_bm, src_lo, src_hi, stats, lvl)
    return bfs_level.live_chunks(frontier_bm, src_lo, src_hi, stats, lvl)


def bfs_core_merge(cand: torch.Tensor, visited_bm: torch.Tensor,
                   parent_ext: torch.Tensor) -> None:
    """The bottom-up core step's merge, in place: each unvisited row i <
    min(K, V) with a candidate (``cand[i] < BIG``, ``core_spmv``'s output)
    takes min(parent_ext[i], cand[i])."""
    if parent_ext.device.type in _PLAIN:
        return ref.bfs_core_merge_ref(cand, visited_bm, parent_ext)
    return bfs_level.core_merge(cand, visited_bm, parent_ext)
