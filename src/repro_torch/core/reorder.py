"""Paper technique T2a: degree-descending vertex relabeling.

Counterpart of ``repro.core.reorder`` (the host sorts of the paper's
Fig. 12 ablation are not ported yet).  After the relabeling the heavy
prefix ``[0, K)`` is contiguous and the isolated vertices form a tail.
"""
from __future__ import annotations

from typing import NamedTuple

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
