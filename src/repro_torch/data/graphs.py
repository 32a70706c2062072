"""Synthetic graph families beyond Kronecker (the SSSP kernel's test beds).

Counterpart of ``grid_graph`` and ``erdos_renyi_graph`` in
``repro.data.graphs``.  Both are drawn with numpy's ``default_rng``, so a
seed gives the same edges as the JAX package's, and the same edges on
every device (torch's CPU and CUDA generators do not share a stream):

  * :func:`grid_graph` — a 2-D grid (road-like): diameter O(side), tiny
    frontiers, hundreds of δ-stepping buckets;
  * :func:`erdos_renyi_graph` — G(n, M) with uniform degree: no heavy tail,
    so the degree sort and heavy core get a graph they cannot help.

Both return the port's :class:`~repro_torch.core.kronecker.EdgeList`, ready
for ``build_csr`` -> ``edge_view`` -> ``compile_plan``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kronecker import EdgeList
from repro_torch.util import resolve_device


def _edge_list(src: np.ndarray, dst: np.ndarray, n: int, device) -> EdgeList:
    device = resolve_device(device)
    return EdgeList(src=torch.from_numpy(src.astype(np.int32)).to(device),
                    dst=torch.from_numpy(dst.astype(np.int32)).to(device),
                    num_vertices=n)


def grid_graph(side: int, *, seed: int = 0, device=None) -> EdgeList:
    """2-D ``side x side`` grid with 4-neighbour edges, one directed
    half-edge per lattice edge (``build_csr`` symmetrizes), vertex labels
    permuted by ``seed``."""
    n = side * side
    ij = np.arange(n, dtype=np.int64)
    i, j = ij // side, ij % side
    right = ij[j < side - 1]
    down = ij[i < side - 1]
    src = np.concatenate([right, down])
    dst = np.concatenate([right + 1, down + side])
    perm = np.random.default_rng(seed).permutation(n).astype(np.int32)
    return _edge_list(perm[src], perm[dst], n, device)


def erdos_renyi_graph(n: int, *, avg_degree: int = 8, seed: int = 0,
                      device=None) -> EdgeList:
    """Erdős–Rényi G(n, M) with ``M = n * avg_degree / 2`` pairs sampled
    with replacement (``build_csr`` dedupes and drops the self loops)."""
    m = (n * avg_degree) // 2
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    return _edge_list(src, dst, n, device)
