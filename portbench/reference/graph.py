"""Plain reference of Graph500 kernel 1: the edge list as a graph.

The same semantics as the program's construction, computed independently
in plain PyTorch: the undirected input edges made symmetric, self loops
dropped, duplicates merged, then the vertices relabelled in descending
degree order (ties by the input id, a stable sort), and the directed
entries sorted by (source, destination).  Nothing here imports the
program.

``dedupe=False`` keeps duplicate entries: the control of the BFS cells,
which breaks the guarantee that each undirected input edge counts once.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class RefGraph:
    num_vertices: int
    new_from_old: torch.Tensor   # [V] int64: input id -> sorted id
    keys: torch.Tensor           # [nnz] int64: src * V + dst, ascending (sorted ids)
    src: torch.Tensor            # [nnz] int64
    dst: torch.Tensor            # [nnz] int64
    degree: torch.Tensor         # [V] int64, sorted ids

    @property
    def nnz(self) -> int:
        return int(self.keys.numel())

    def edge_index(self, u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """For each pair (u, v): whether the entry u -> v exists, and its
        position in the sorted entries (meaningless where it does not)."""
        q = u.to(torch.int64) * self.num_vertices + v.to(torch.int64)
        pos = torch.searchsorted(self.keys, q).clamp(max=max(self.nnz - 1, 0))
        found = (self.keys[pos] == q) if self.nnz else torch.zeros_like(q, dtype=torch.bool)
        return found, pos


def build_graph(src: torch.Tensor, dst: torch.Tensor, num_vertices: int, *,
                dedupe: bool = True) -> RefGraph:
    v = int(num_vertices)
    s0, d0 = src.to(torch.int64), dst.to(torch.int64)
    keep = s0 != d0
    s0, d0 = s0[keep], d0[keep]
    key = torch.cat([s0 * v + d0, d0 * v + s0])
    del s0, d0, keep
    key = torch.unique(key) if dedupe else torch.sort(key).values
    degree_old = torch.bincount(key // v, minlength=v)
    old_from_new = torch.sort(-degree_old, stable=True).indices
    new_from_old = torch.empty_like(old_from_new)
    new_from_old[old_from_new] = torch.arange(v, device=key.device)
    key = new_from_old[key // v] * v + new_from_old[key % v]
    key = torch.sort(key).values
    return RefGraph(num_vertices=v, new_from_old=new_from_old, keys=key,
                    src=key // v, dst=key % v, degree=degree_old[old_from_new])
