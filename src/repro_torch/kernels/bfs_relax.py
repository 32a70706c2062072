"""The bitmap BFS level's relax: the wrapper of ``csrc/bfs_relax.cu``.

One C-entry call a level, in the level's direction, over the rows of the
source-sorted edge view (vertex u's neighbours are ``dst[row_start[u] :
row_start[u] + degree[u]]``, ascending) and the parent array ``[V + 1]``
with the sentinel ``V``::

    top-down:  for each frontier vertex u, each entry u -> v of its row,
               v not visited:  parent[v] = min(parent[v], u)
    bottom-up: for each v with parent[v] == V (unvisited, not won by the
               core step):     parent[v] = its first row entry in the
               frontier, the entries inside the core skipped on a core row

Both give each vertex found its least frontier neighbour, as the JAX
engine's scatter-min over edge lanes does on the undirected graph.  No TPU
kernel stands behind it.  ``kernels.ops.bfs_relax_top_down`` /
``bfs_relax_bottom_up`` dispatch a CPU tensor to the plain versions instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, StreamScratch, frontier_list_scratch
from repro_torch.kernels.ref import check_bfs_relax_inputs

KERNEL = CudaKernel("bfs_relax", "bfs_relax_launch", [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_void_p,
])

#: Vertices a block of the frontier's scan takes: 256 threads, a bitmap word
#: each (csrc/bfs_relax.cu's kThreads).
SCAN_TILE = 256 * 32

#: The top-down scratch of one (device index, stream) for V vertices: the
#: frontier list's.
scratch_for = StreamScratch(lambda device, v: frontier_list_scratch(device, v, SCAN_TILE))


def _on_card(parent_ext) -> tuple[int, int]:
    if not parent_ext.is_cuda:
        raise ValueError(f"bfs_relax: the kernel takes CUDA tensors, got {parent_ext.device}")
    dev = parent_ext.get_device()
    return dev, torch._C._cuda_getCurrentRawStream(dev)


def top_down(frontier_bm, visited_bm, degree, row_start, dst, parent_ext) -> None:
    """Launch the frontier's scan, compaction and the top-down relax;
    updates ``parent_ext`` in place, on the current stream, and allocates
    nothing after a stream's first call for this many vertices."""
    check_bfs_relax_inputs(frontier_bm, degree, row_start, dst, parent_ext,
                           visited_bm=visited_bm)
    dev, stream = _on_card(parent_ext)
    v = degree.shape[0]
    KERNEL(0, frontier_bm.data_ptr(), visited_bm.data_ptr(), degree.data_ptr(),
           row_start.data_ptr(), dst.data_ptr(), None, 0, parent_ext.data_ptr(), None,
           *scratch_for(dev, stream, v), v, stream)


def bottom_up(frontier_bm, parent_ext, degree, row_start, dst, core_deg,
              entries_read=None) -> None:
    """Launch the bottom-up relax; updates ``parent_ext`` in place and, when
    given, adds the row entries read to ``entries_read`` (int64 scalar), on
    the current stream."""
    check_bfs_relax_inputs(frontier_bm, degree, row_start, dst, parent_ext,
                           core_deg=core_deg, entries_read=entries_read)
    _, stream = _on_card(parent_ext)
    KERNEL(1, frontier_bm.data_ptr(), None, degree.data_ptr(), row_start.data_ptr(),
           dst.data_ptr(), core_deg.data_ptr(), core_deg.shape[0], parent_ext.data_ptr(),
           None if entries_read is None else entries_read.data_ptr(),
           None, None, None, None, None, degree.shape[0], stream)
