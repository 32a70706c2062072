"""Plain reference searches over a :class:`~portbench.reference.graph.RefGraph`.

``bfs_levels``: level-synchronous breadth-first search, every edge out of
the frontier relaxed each level.  ``sssp_distances``: Bellman-Ford from
the root, relaxing the out-edges of the vertices whose distance fell in
the previous round, in the weights' dtype: exact int64 sums for integer
weights, one rounded add an edge for real ones.  ``components``: connected
component labels (least vertex id) by min-label propagation, with the
undirected input edges each search traverses counted per component.
Each runs on the device its graph lies on, and none imports the program.
"""
from __future__ import annotations

import torch

UNREACHED = -1


def reached(dist: torch.Tensor) -> torch.Tensor:
    """bool [V]: the vertices a search reached; -1 marks an unreached
    integer distance or level, +inf an unreached real distance."""
    return torch.isfinite(dist) if dist.is_floating_point() else dist >= 0


def bfs_levels(g, root: int, keep: torch.Tensor | None = None) -> torch.Tensor:
    """int64 [V]: hops from ``root``, -1 where unreached; over the entries
    ``keep`` marks, or all."""
    v = g.num_vertices
    level = torch.full((v,), UNREACHED, dtype=torch.int64, device=g.keys.device)
    level[root] = 0
    front = torch.zeros(v, dtype=torch.bool, device=g.keys.device)
    front[root] = True
    visited = front.clone()
    depth = 0
    while bool(front.any()):
        nxt = torch.zeros_like(front)
        out = front[g.src] if keep is None else front[g.src] & keep
        nxt[g.dst[out]] = True
        nxt &= ~visited
        depth += 1
        level[nxt] = depth
        visited |= nxt
        front = nxt
    return level


def sssp_distances(g, weight: torch.Tensor, root: int) -> torch.Tensor:
    """[V] in ``weight``'s dtype: shortest-path distances from ``root`` under
    ``weight`` (one per sorted entry); -1 where unreached for integer
    weights, +inf for real ones."""
    v = g.num_vertices
    real = weight.is_floating_point()
    inf = float("inf") if real else torch.iinfo(weight.dtype).max
    dist = torch.full((v,), inf, dtype=weight.dtype, device=g.keys.device)
    dist[root] = 0
    front = torch.zeros(v, dtype=torch.bool, device=g.keys.device)
    front[root] = True
    while bool(front.any()):
        act = front[g.src]
        cand = dist[g.src[act]] + weight[act]
        new = dist.scatter_reduce(0, g.dst[act], cand, "amin", include_self=True)
        front = new < dist
        dist = new
    return dist if real else torch.where(dist == inf, UNREACHED, dist)


def components(g) -> torch.Tensor:
    """int64 [V]: the least vertex id of each vertex's component."""
    lab = torch.arange(g.num_vertices, device=g.keys.device)
    while True:
        new = lab.scatter_reduce(0, g.dst, lab[g.src], "amin", include_self=True)
        new = new[new]          # pointer jumping: a label's own label
        if torch.equal(new, lab):
            return lab
        lab = new


def traversed_edges(g, labels: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """int64 per root: the undirected input edges (self loops dropped,
    duplicates merged) inside the root's component, which is what the
    Graph500 TEPS of a search from it counts."""
    per_comp = torch.zeros(g.num_vertices, dtype=torch.int64, device=g.keys.device)
    per_comp.scatter_add_(0, labels, g.degree)
    return per_comp[labels[roots.to(torch.int64)]] // 2


def bfs_parents(g, level: torch.Tensor, root: int) -> torch.Tensor:
    """int64 [V]: the least neighbour one level up of each reached vertex,
    the root its own parent, -1 where unreached."""
    ok = (level[g.src] >= 0) & (level[g.src] == level[g.dst] - 1)
    return _least_source(g, ok, root)


def sssp_parents(g, weight: torch.Tensor, dist: torch.Tensor, root: int) -> torch.Tensor:
    """int64 [V]: the least neighbour on a shortest path to each reached
    vertex, the root its own parent, -1 where unreached.  Where a zero
    weight lies on a shortest path, two vertices at one distance can each
    be the other's least such neighbour: then a parent must also lie one hop
    nearer the root over the shortest paths' entries, so the parents form a
    tree."""
    ok = reached(dist)[g.src] & (dist[g.src] + weight == dist[g.dst])
    if bool((ok & (weight == 0)).any()):
        hops = bfs_levels(g, root, keep=ok)
        ok &= hops[g.src] == hops[g.dst] - 1
    return _least_source(g, ok, root)


def _least_source(g, ok: torch.Tensor, root: int) -> torch.Tensor:
    v = g.num_vertices
    p = torch.full((v,), v, dtype=torch.int64, device=g.keys.device)
    p.scatter_reduce_(0, g.dst[ok], g.src[ok], "amin", include_self=True)
    p = torch.where(p == v, UNREACHED, p)
    p[root] = root
    return p
