"""A plain float32 Bellman-Ford for the real-weight SSSP tests.

It imports nothing of the port and no JAX: it reads an edge list (source,
destination, float32 weight per directed entry) and relaxes, round after
round, every entry out of the vertices whose distance fell, each sum one
float32 add rounded to nearest.  Every label-correcting order reaches the
same least fixed point, so its distances are the exact answer of the
program's δ-stepping, bit for bit.
"""
from __future__ import annotations

import torch


def bellman_ford_f32(src: torch.Tensor, dst: torch.Tensor, weight: torch.Tensor,
                     num_vertices: int, root: int) -> torch.Tensor:
    """float32 [V]: the distances from ``root``, +inf where unreached."""
    s, d = src.long(), dst.long()
    w = weight.to(torch.float32)
    dist = torch.full((num_vertices,), float("inf"), dtype=torch.float32)
    dist[root] = 0.0
    front = torch.zeros(num_vertices, dtype=torch.bool)
    front[root] = True
    while bool(front.any()):
        act = front[s]
        cand = dist[s[act]] + w[act]
        new = dist.scatter_reduce(0, d[act], cand, "amin", include_self=True)
        front = new < dist
        dist = new
    return dist


def least_source_parents(src: torch.Tensor, dst: torch.Tensor, weight: torch.Tensor,
                         dist: torch.Tensor, root: int) -> torch.Tensor:
    """int64 [V]: each reached vertex's least neighbour u with
    fl(dist[u] + w) == dist[v] (the integer engines' rule: a tie lowers the
    parent), the root its own parent, -1 where unreached."""
    v = dist.shape[0]
    s, d = src.long(), dst.long()
    ok = torch.isfinite(dist[s]) & (dist[s] + weight.to(torch.float32) == dist[d])
    p = torch.full((v,), v, dtype=torch.int64)
    p.scatter_reduce_(0, d[ok], s[ok], "amin", include_self=True)
    p = torch.where(p == v, -1, p)
    p[root] = root
    return p


def chains_reach(parent: torch.Tensor, root: int) -> torch.Tensor:
    """bool [V]: whether each vertex's chain of parents reaches ``root``
    (an unreached vertex, parent -1, does not), by pointer jumping until
    every chain has stopped (at the root, or in a cycle)."""
    v = parent.shape[0]
    up = torch.where(parent >= 0, parent.long(), torch.arange(v))
    up[root] = root
    for _ in range(v):
        up = up[up]
        if bool((up[up] == up).all()):
            break
    return up == root
