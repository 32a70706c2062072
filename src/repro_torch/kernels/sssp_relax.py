"""Frontier-driven δ-stepping relax: the wrapper of ``csrc/sssp_relax.cu``.

One round of the SSSP engine's relax over the packed state, one uint64 per
vertex carried in an int64 tensor as ``(dist << 32) | parent``::

    for each frontier vertex u, each entry (u -> v, w) of its row:
        cand = ((dist[u] + w) mod 2^32) << 32 | u       # dist[u] before the round
        state[v] = min(state[v], cand)                  # unsigned
        changed[v] |= the distance half of state[v] fell

The frontier comes as ``front_deg``, its vertices' out-degrees (0 off the
frontier).  No TPU kernel stands behind it: the JAX engine relaxes with two
plain scatter-min passes over every edge entry.  This wrapper launches the
frontier's scan and compaction and the relax in one C-entry call, with no
host synchronisation; ``kernels.ops.sssp_relax`` dispatches a CPU tensor to
the plain version instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.ref import check_relax_inputs

KERNEL = CudaKernel("sssp_relax", "sssp_relax_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_void_p,
])

#: Vertices a block of the frontier's scan takes (csrc/sssp_relax.cu's kTile).
SCAN_TILE = 1024

#: (device index, raw stream) -> (V, scratch pointers, scratch tensors): the
#: per-block sums, the two totals and the frontier list.  A stream runs its
#: calls in order, so one scratch serves every call on it.
_scratch: dict = {}


def scratch_for(device: int, stream: int, v: int) -> tuple:
    """The data pointers of the scratch for ``v`` vertices on one (device
    index, stream), allocated on first use and again when ``v`` changes."""
    entry = _scratch.get((device, stream))
    if entry is None or entry[0] != v:
        n_parts = -(-v // SCAN_TILE)
        on = dict(device=f"cuda:{device}")
        bufs = (torch.empty(n_parts, dtype=torch.int32, **on),    # per-block vertices
                torch.empty(n_parts, dtype=torch.int64, **on),    # per-block entries
                torch.empty(2, dtype=torch.int64, **on),          # the totals
                torch.empty(v, dtype=torch.int32, **on),          # the list: vertex,
                torch.empty(v, dtype=torch.int64, **on),          # first entry,
                torch.empty(v, dtype=torch.int32, **on))          # round-start distance
        entry = _scratch[(device, stream)] = (v, tuple(t.data_ptr() for t in bufs), bufs)
    return entry[1]


def sssp_relax(state, changed, front_deg, row_start, dst, weight) -> None:
    """Launch the frontier's scan, compaction and relax; updates ``state``
    and ``changed`` in place, on the current stream, and allocates
    nothing after a stream's first call for this many vertices."""
    check_relax_inputs(state, changed, front_deg, row_start, dst, weight)
    if not state.is_cuda:
        raise ValueError(f"sssp_relax: the kernel takes CUDA tensors, got {state.device}")
    v, dev = state.shape[0], state.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    KERNEL(state.data_ptr(), changed.data_ptr(), front_deg.data_ptr(), row_start.data_ptr(),
           dst.data_ptr(), weight.data_ptr(), *scratch_for(dev, stream, v), v, stream)
