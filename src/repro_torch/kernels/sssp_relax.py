"""Frontier-driven δ-stepping relax: the wrapper of ``csrc/sssp_relax.cu``.

One round of the SSSP engine's relax over the packed state, one uint64 per
vertex carried in an int64 tensor as ``(dist << 32) | parent``::

    for each frontier vertex u, each entry (u -> v, w) of its row:
        cand = ((dist[u] + w) mod 2^32) << 32 | u       # dist[u] before the round
        state[v] = min(state[v], cand)                  # unsigned
        changed[v] |= the distance half of state[v] fell

The frontier comes as ``front_deg``, its vertices' out-degrees (0 off the
frontier).  With float32 weights (real weights) the distances are float32
bits, the add rounds to nearest and a candidate's low half carries its hop
count (``ref.sssp_relax_ref`` says the rule); the kernels' second
instantiation runs it.  No TPU kernel stands behind it: the JAX engine
relaxes with two plain scatter-min passes over every edge entry.  This
wrapper launches the frontier's scan and compaction and the relax in one
C-entry call, with no host synchronisation; ``kernels.ops.sssp_relax``
dispatches a CPU tensor to the plain version instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, StreamScratch, frontier_list_scratch
from repro_torch.kernels.ref import check_relax_inputs, real_key_bits

KERNEL = CudaKernel("sssp_relax", "sssp_relax_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
])

#: Vertices a block of the frontier's scan takes (csrc/sssp_relax.cu's kTile).
SCAN_TILE = 1024

#: The scratch of one (device index, stream) for V vertices: the frontier
#: list's, with each listed vertex's round-start distance beside it.
scratch_for = StreamScratch(lambda device, v: frontier_list_scratch(device, v, SCAN_TILE) + (
    torch.empty(v, dtype=torch.int32, device=device),))

#: Real weights' scratch beside it: each listed vertex's round-start low half.
real_scratch_for = StreamScratch(lambda device, v: (
    torch.empty(v, dtype=torch.int32, device=device),))


def sssp_relax(state, changed, front_deg, row_start, dst, weight) -> None:
    """Launch the frontier's scan, compaction and relax; updates ``state``
    and ``changed`` in place, on the current stream, and allocates
    nothing after a stream's first call for this many vertices."""
    check_relax_inputs(state, changed, front_deg, row_start, dst, weight)
    if not state.is_cuda:
        raise ValueError(f"sssp_relax: the kernel takes CUDA tensors, got {state.device}")
    v, dev = state.shape[0], state.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if weight.dtype is torch.float32:
        flow, pbits = real_scratch_for(dev, stream, v)[0], real_key_bits(v)[0]
    else:
        flow, pbits = None, 0
    KERNEL(state.data_ptr(), changed.data_ptr(), front_deg.data_ptr(), row_start.data_ptr(),
           dst.data_ptr(), weight.data_ptr(), *scratch_for(dev, stream, v), flow, pbits, v,
           stream)
