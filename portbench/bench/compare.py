"""The comparison that decides ``correct``.

The program's outputs, as the timed path produced them, against the plain
reference (``portbench/reference``), which recomputes everything from the
same generated edge list, keys and seed:

  ``graph_mismatch``  entries of the built graph that differ: the degree of
                      every vertex, and the sorted directed entries (and, for
                      SSSP, their weights) after the degree-sort relabelling;
  ``edges_mismatch``  searches in the window whose traversed-edge count,
                      the numerator of their TEPS, differs from the
                      reference's count for that key;
  ``level_mismatch``  vertices of the checked searches whose BFS level or
                      SSSP distance differs from the reference's;
  ``parent_invalid``  vertices of the checked searches whose parent is not
                      a tree parent the specification accepts: unreached
                      vertices with a parent, a root not its own parent, a
                      parent that is no neighbour, or one that does not lie
                      one level up (BFS) / at distance minus the edge's weight
                      (SSSP);
  ``root_invalid``    searches in the window whose key is not its own
                      parent at level (distance) 0 in their answer.

Each is an exact count, so each limit is 0 (``LIMITS``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from portbench.reference.graph import build_graph
from portbench.reference.search import (
    bfs_levels, components, sssp_distances, traversed_edges,
)
from portbench.reference.weights import edge_weights

LIMITS = {"graph_mismatch": 0, "edges_mismatch": 0, "level_mismatch": 0,
          "parent_invalid": 0, "root_invalid": 0}


@dataclass
class Outputs:
    """What the timed path produced, handed to the comparison.

    ``src``/``dst``/``weight`` are the built graph's first ``nnz`` directed
    entries (program ids); ``search_keys[i]`` is the key index of the
    window's ``i``-th search, ``search_edges[i]`` its traversed-edge count
    and ``search_roots[i]`` its answer's (parent, level) at its key;
    ``checked`` holds ``(search index, key index, parent, level)``
    of the sampled searches."""

    nnz: int
    src: torch.Tensor
    dst: torch.Tensor
    degree: torch.Tensor
    weight: torch.Tensor | None
    search_keys: list
    search_edges: list
    checked: list = field(default_factory=list)
    search_roots: list = field(default_factory=list)


@dataclass
class Inputs:
    """What the benchmark generated and hands to both sides."""

    src: torch.Tensor      # input edge list (input labels)
    dst: torch.Tensor
    num_vertices: int
    keys: torch.Tensor     # [n_keys] input labels
    kernel: str            # "bfs" | "sssp"
    seed: int
    max_weight: int = 255


def graph_mismatch(out: Outputs, g, w_ref) -> int:
    bad = int((out.degree.to(torch.int64) != g.degree).sum())
    n = min(out.nnz, g.nnz)
    diff = (out.src[:n].to(torch.int64) != g.src[:n]) | (out.dst[:n].to(torch.int64) != g.dst[:n])
    if w_ref is not None:
        diff |= out.weight[:n].to(torch.int64) != w_ref[:n]
    return bad + int(diff.sum()) + abs(out.nnz - g.nnz)


def bfs_parent_invalid(g, parent, level_ref, root: int) -> int:
    v = g.num_vertices
    p = parent.to(torch.int64)
    ids = torch.arange(v, device=p.device)
    reached = level_ref >= 0
    pc = p.clamp(0, v - 1)
    found, _ = g.edge_index(pc, ids)
    ok = (p >= 0) & (p < v) & found & (level_ref[pc] == level_ref - 1)
    bad = (reached & (ids != root) & ~ok) | (~reached & (p != -1))
    return int(bad.sum()) + int(int(p[root]) != root)


def sssp_parent_invalid(g, weight, parent, dist_ref, root: int) -> int:
    v = g.num_vertices
    p = parent.to(torch.int64)
    ids = torch.arange(v, device=p.device)
    reached = dist_ref >= 0
    pc = p.clamp(0, v - 1)
    found, pos = g.edge_index(pc, ids)
    ok = ((p >= 0) & (p < v) & found & (dist_ref[pc] >= 0)
          & (dist_ref[pc] + weight[pos] == dist_ref))
    bad = (reached & (ids != root) & ~ok) | (~reached & (p != -1))
    return int(bad.sum()) + int(int(p[root]) != root)


def compare(out: Outputs, inp: Inputs) -> dict:
    """The compared numbers (see the module docstring), the count of
    answers found wrong and of those checked whole, and the traversed-edge
    count of each key's component (``key_edges``)."""
    g = build_graph(inp.src, inp.dst, inp.num_vertices)
    w_ref = (edge_weights(g.src, g.dst, seed=inp.seed, max_weight=inp.max_weight)
             if inp.kernel == "sssp" else None)
    nums = {"graph_mismatch": graph_mismatch(out, g, w_ref)}

    roots = g.new_from_old[inp.keys.to(torch.int64)]
    m_ref = traversed_edges(g, components(g), roots).cpu().tolist()
    wrong = {i for i, (k, m) in enumerate(zip(out.search_keys, out.search_edges))
             if int(m) != m_ref[k]}
    nums["edges_mismatch"] = len(wrong)
    bad_roots = {i for i, (k, (p, lev)) in enumerate(zip(out.search_keys, out.search_roots))
                 if p != int(roots[k]) or lev != 0}
    nums["root_invalid"] = len(bad_roots)
    wrong |= bad_roots

    lev_bad = par_bad = 0
    for i, k, parent, level in out.checked:
        root = int(roots[k])
        if inp.kernel == "sssp":
            ref = sssp_distances(g, w_ref, root)
            pb = sssp_parent_invalid(g, w_ref, parent, ref, root)
        else:
            ref = bfs_levels(g, root)
            pb = bfs_parent_invalid(g, parent, ref, root)
        lb = int((level.to(torch.int64) != ref).sum())
        lev_bad, par_bad = lev_bad + lb, par_bad + pb
        if lb or pb:
            wrong.add(i)
    nums["level_mismatch"] = lev_bad
    nums["parent_invalid"] = par_bad
    return {"numbers": nums, "failed": len(wrong), "checked": len(out.checked),
            "answers": len(out.search_keys), "key_edges": m_ref}


def verdict(nums: dict) -> bool:
    return all(nums[k] <= lim for k, lim in LIMITS.items())
