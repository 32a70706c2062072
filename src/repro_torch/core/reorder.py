"""Paper technique T2a: degree-descending vertex relabeling.

Counterpart of ``repro.core.reorder``, with the host sorts of the
paper's Fig. 12 ablation.  After the relabeling the heavy prefix
``[0, K)`` is contiguous and the isolated vertices form a tail.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph_build import CSRGraph, build_csr
from repro_torch.core.kronecker import EdgeList


class Reordering(NamedTuple):
    new_from_old: torch.Tensor   # [V] int32: old id -> new id
    old_from_new: torch.Tensor   # [V] int32: new id -> old id
    n_active: torch.Tensor       # [] int32: vertices with degree > 0
    degree_sorted: torch.Tensor  # [V] int32: degree in new-id order (desc)


def degree_reorder(degree: torch.Tensor) -> Reordering:
    """Stable degree-descending permutation (ties broken by old id)."""
    v = degree.shape[0]
    old_from_new = torch.argsort(-degree, stable=True).to(torch.int32)
    new_from_old = torch.empty(v, dtype=torch.int32, device=degree.device)
    new_from_old[old_from_new.long()] = torch.arange(
        v, dtype=torch.int32, device=degree.device)
    degree_sorted = degree[old_from_new.long()]
    n_active = (degree > 0).sum().to(torch.int32)
    return Reordering(new_from_old, old_from_new, n_active, degree_sorted)


def relabel_edges(edges: EdgeList, r: Reordering) -> EdgeList:
    return EdgeList(src=r.new_from_old[edges.src.long()],
                    dst=r.new_from_old[edges.dst.long()],
                    num_vertices=edges.num_vertices)


def reorder_graph(edges: EdgeList) -> tuple[CSRGraph, Reordering, EdgeList]:
    """Build -> measure degrees -> relabel -> rebuild. Returns the sorted CSR."""
    g0 = build_csr(edges)
    r = degree_reorder(g0.degree)
    e1 = relabel_edges(edges, r)
    return build_csr(e1), r, e1


# ---------------------------------------------------------------------------
# Host-side classical sorts (paper Fig. 12 ablation), numpy copies of the
# JAX package's. Production never calls these; the ablation compares their
# wall time + the resulting (identical) permutation against the library
# argsort.
# ---------------------------------------------------------------------------

def _merge_sort_perm(keys: np.ndarray) -> np.ndarray:
    n = len(keys)
    perm = np.arange(n)
    width = 1
    buf = perm.copy()
    while width < n:
        for lo in range(0, n, 2 * width):
            mid = min(lo + width, n)
            hi = min(lo + 2 * width, n)
            li, ri, k = lo, mid, lo
            while li < mid and ri < hi:
                # stable: <= keeps left element first on ties
                if keys[perm[li]] <= keys[perm[ri]]:
                    buf[k] = perm[li]; li += 1
                else:
                    buf[k] = perm[ri]; ri += 1
                k += 1
            while li < mid:
                buf[k] = perm[li]; li += 1; k += 1
            while ri < hi:
                buf[k] = perm[ri]; ri += 1; k += 1
        perm, buf = buf, perm
        width *= 2
    return perm


def _quick_sort_perm(keys: np.ndarray) -> np.ndarray:
    # iterative 3-way quicksort on (key, idx) pairs for stability
    pairs = list(zip(keys.tolist(), range(len(keys))))
    stack = [(0, len(pairs) - 1)]
    while stack:
        lo, hi = stack.pop()
        if lo >= hi:
            continue
        pivot = pairs[(lo + hi) // 2]
        i, j = lo, hi
        while i <= j:
            while pairs[i] < pivot:
                i += 1
            while pairs[j] > pivot:
                j -= 1
            if i <= j:
                pairs[i], pairs[j] = pairs[j], pairs[i]
                i += 1; j -= 1
        stack.append((lo, j))
        stack.append((i, hi))
    return np.array([p[1] for p in pairs], dtype=np.int64)


def _bubble_sort_perm(keys: np.ndarray) -> np.ndarray:
    keys = keys.copy()
    perm = np.arange(len(keys))
    n = len(keys)
    for i in range(n):
        swapped = False
        for j in range(n - 1 - i):
            if keys[j] > keys[j + 1]:
                keys[j], keys[j + 1] = keys[j + 1], keys[j]
                perm[j], perm[j + 1] = perm[j + 1], perm[j]
                swapped = True
        if not swapped:
            break
    return perm


_HOST_SORTS = {
    "merge": _merge_sort_perm,
    "quick": _quick_sort_perm,
    "bubble": _bubble_sort_perm,
}


def sort_host(degree: np.ndarray, algorithm: str) -> np.ndarray:
    """Degree-descending permutation via a classical host sort (Fig. 12).

    ``"xla"`` is the library sort, here a stable ``torch.argsort`` of the
    negated degrees; it keeps the JAX package's name so that the Fig. 12
    comparison reads the same in both packages."""
    if algorithm == "xla":
        neg = torch.from_numpy(-np.asarray(degree, dtype=np.int64))
        return torch.argsort(neg, stable=True).numpy()
    fn = _HOST_SORTS[algorithm]
    # sort ascending on key = (-degree, id) encoded: stable sorts only need -degree
    return fn(-degree.astype(np.int64))
