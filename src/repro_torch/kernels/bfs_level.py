"""The bitmap BFS level's bookkeeping: the wrappers of ``csrc/bfs_level_delta.cu``,
``bfs_level_stats.cu``, ``bfs_live_chunks.cu`` and ``bfs_core_merge.cu``.

Four launches around a level's relax keep everything a level computes on the
device but two numbers the host reads back together: the next frontier's
size, which ``frontier_update`` counts, for the direction switch, and the
core rows left unvisited, which ``stats`` counts, for skipping the core step:

    delta   found = the vertices with a parent that are not visited, packed;
            level[found] = lvl + 1; acc gets their degree sum and popcount
    stats   after frontier_update: the level's column of the stats (its
            direction and frontier size, the three sentinels, the scanned
            edges, a bottom-up level's scanned chunks), and acc's frontier
            and visited degree sums for the next level and the levels run;
            and the core rows left unvisited, which the host reads back
            with the frontier's size
    chunks  a top-down level's scanned chunks into its column
    merge   a bottom-up level's core candidates into the parents

No TPU kernel stands behind them: the JAX engine's level body is plain jnp
that XLA fuses.  ``kernels.ops`` dispatches a CPU tensor to the plain
versions in ``ref.py`` (``bfs_level_delta_ref`` and the others) instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, StreamScratch
from repro_torch.kernels.ref import (
    STATS_CH, check_core_merge_operands, check_level_delta_operands,
    check_level_stats_operands, check_live_chunks_operands,
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

DELTA = CudaKernel("bfs_level_delta", "level_delta_launch",
                   [_P, _P, _P, _P, _I, _P, _P, _P, _L, _L, _P])
STATS = CudaKernel("bfs_level_stats", "level_stats_launch",
                   [_P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _L, _P, _P, _L, _P])
CHUNKS = CudaKernel("bfs_live_chunks", "live_chunks_launch", [_P, _L, _P, _P, _I, _P, _P, _P])
MERGE = CudaKernel("bfs_core_merge", "core_merge_launch", [_P, _P, _P, _L, _I, _P])

#: The delta's and the stats' scratch: the ticket and two slots for each of
#: at most 132 * 8 blocks (csrc/bfs_level.cuh's kMaxBlocks); the chunk
#: count's the ticket and a slot for each of a chunk's 8 parts
#: (bfs_live_chunks.cu's kParts).
LEVEL_SCRATCH_WORDS = 1 + 2 * 132 * 8
CHUNK_PARTS = 8

#: One scratch of each kind per (device index, stream), zeroed at allocation:
#: a stream runs its launches in order and each leaves its ticket at 0.
level_scratch = StreamScratch(
    lambda device, _: (torch.zeros(LEVEL_SCRATCH_WORDS, dtype=torch.int32, device=device),))
chunk_scratch = StreamScratch(
    lambda device, n_chunks: (torch.zeros(1 + CHUNK_PARTS * n_chunks, dtype=torch.int32,
                                          device=device),))


def _stream(t: torch.Tensor, name: str) -> tuple[int, int]:
    if not t.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
    dev = t.get_device()
    return dev, torch._C._cuda_getCurrentRawStream(dev)


def delta(parent_ext, visited_bm, degree, level, next_level: int, found, acc) -> None:
    """Launch the level's delta: writes ``found`` (every word), the found
    vertices' ``level`` and ``acc``'s delta slots, on the current stream."""
    check_level_delta_operands(parent_ext, visited_bm, degree, level, found, acc)
    dev, stream = _stream(parent_ext, "bfs_level_delta")
    DELTA(parent_ext.data_ptr(), visited_bm.data_ptr(), degree.data_ptr(), level.data_ptr(),
          next_level, found.data_ptr(), acc.data_ptr(), *level_scratch(dev, stream),
          degree.shape[0], found.shape[0], stream)


def stats(next_bm, visited_bm, count, acc, stats_dev, lvl: int, bottom_up: bool,
          in_count: int, n_chunks: int, core_rows: int = 0, unvisited=None) -> None:
    """Launch the level's sentinels and stats into column ``lvl`` of
    ``stats_dev`` and roll ``acc`` on to the next level; with ``unvisited``,
    the count of the first ``core_rows`` rows left unvisited goes there."""
    check_level_stats_operands(next_bm, visited_bm, count, acc, stats_dev, lvl, core_rows,
                               unvisited)
    dev, stream = _stream(next_bm, "bfs_level_stats")
    STATS(next_bm.data_ptr(), visited_bm.data_ptr(), count.data_ptr(), acc.data_ptr(),
          stats_dev.data_ptr(), stats_dev.shape[1], lvl, int(bottom_up), in_count, n_chunks,
          core_rows, None if unvisited is None else unvisited.data_ptr(),
          *level_scratch(dev, stream), next_bm.shape[0], stream)


def live_chunks(frontier_bm, src_lo, src_hi, stats_dev, lvl: int) -> None:
    """Launch the count of the chunks live in ``frontier_bm`` into
    ``stats_dev``'s chunk row at column ``lvl``."""
    check_live_chunks_operands(frontier_bm, src_lo, src_hi, stats_dev, lvl)
    dev, stream = _stream(frontier_bm, "bfs_live_chunks")
    n = src_lo.shape[0]
    out = stats_dev.data_ptr() + 4 * (STATS_CH * stats_dev.shape[1] + lvl)
    CHUNKS(frontier_bm.data_ptr(), frontier_bm.shape[0], src_lo.data_ptr(), src_hi.data_ptr(),
           n, out, *chunk_scratch(dev, stream, n), stream)


def core_merge(cand, visited_bm, parent_ext) -> None:
    """Launch the merge of the core's candidates into ``parent_ext``'s first
    min(K, V) rows."""
    check_core_merge_operands(cand, visited_bm, parent_ext)
    _, stream = _stream(parent_ext, "bfs_core_merge")
    v = parent_ext.shape[0] - 1
    MERGE(cand.data_ptr(), visited_bm.data_ptr(), parent_ext.data_ptr(),
          min(cand.shape[0], v), v, stream)
