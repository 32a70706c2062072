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
                      one level up (BFS) / at a distance that the edge's
                      weight adds up to the vertex's (SSSP); under a weight
                      scheme whose weights can be 0, also a reached vertex
                      whose chain of parents does not reach the key;
  ``root_invalid``    searches in the window whose key is not its own
                      parent at level (distance) 0 in their answer.

Each is an exact count, so each limit is 0 (``LIMITS``).

SSSP's weights, distances and their sums are in the dtype of the
configuration's weight scheme (``portbench/weights/<scheme>.py``), which
also reads the program's planes.  Real (float32) weights need no tolerance:
each relaxation is one float32 add rounded to nearest, and fl(x + w) is
monotone in x and never below x (w >= 0).  So every label-correcting order,
the reference's Bellman-Ford and the program's delta-stepping alike, reaches
the same least fixed point: for each vertex the minimum, over the paths from
the key, of the path's float32 fold.  The parent test fl(dist[p] + w) ==
dist[v] is exact for the same reason.  A zero weight lets two vertices at
one distance pass that test as each other's parent, so a scheme with zero
weights has its parents' chains followed to the key as well (pointer
jumping), the specification's tree check.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from portbench.reference.graph import build_graph
from portbench.reference.search import (
    bfs_levels, components, reached, sssp_distances, traversed_edges,
)

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
    weights: object = None  # SSSP: the weight scheme (``Benchmark.weights``)
    doc: dict = field(default_factory=dict)   # the configuration


def graph_mismatch(out: Outputs, g, w_ref, weights=None) -> int:
    bad = int((out.degree.to(torch.int64) != g.degree).sum())
    n = min(out.nnz, g.nnz)
    diff = (out.src[:n].to(torch.int64) != g.src[:n]) | (out.dst[:n].to(torch.int64) != g.dst[:n])
    if w_ref is not None:
        diff |= weights.decode_weights(out.weight[:n]) != w_ref[:n]
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


def sssp_parent_invalid(g, weight, parent, dist_ref, root: int, chains: bool = False) -> int:
    """With ``chains``, a reached vertex whose parents' chain does not reach
    ``root`` counts too."""
    v = g.num_vertices
    p = parent.to(torch.int64)
    ids = torch.arange(v, device=p.device)
    hit = reached(dist_ref)
    pc = p.clamp(0, v - 1)
    found, pos = g.edge_index(pc, ids)
    ok = ((p >= 0) & (p < v) & found & hit[pc]
          & (dist_ref[pc] + weight[pos] == dist_ref))
    bad = (hit & (ids != root) & ~ok) | (~hit & (p != -1))
    if chains:
        bad |= hit & ~reaches_root(torch.where(ok, pc, ids), root)
    return int(bad.sum()) + int(int(p[root]) != root)


def reaches_root(up: torch.Tensor, root: int) -> torch.Tensor:
    """bool [V]: whether each vertex's chain through ``up`` (a vertex's
    parent, or itself where the chain stops) reaches ``root``, by pointer
    jumping: after k doublings ``up`` is each vertex's 2^k-th ancestor, and
    a chain that reaches the root does so within V - 1 steps."""
    up = up.clone()
    up[root] = root
    for _ in range(max(1, (up.numel() - 1).bit_length())):
        up = up[up]
    return up == root


def distance_mismatch(weights, level, dist_ref) -> int:
    """Vertices whose program distance differs from the reference's, or
    that one side reached and the other did not."""
    dist, got = weights.decode_distances(level)
    want = reached(dist_ref)
    return int(((got != want) | (want & (dist != dist_ref))).sum())


def compare(out: Outputs, inp: Inputs) -> dict:
    """The compared numbers (see the module docstring), the count of
    answers found wrong and of those checked whole, and the traversed-edge
    count of each key's component (``key_edges``)."""
    g = build_graph(inp.src, inp.dst, inp.num_vertices)
    w_ref = (inp.weights.reference(g.src, g.dst, seed=inp.seed, doc=inp.doc)
             if inp.kernel == "sssp" else None)
    nums = {"graph_mismatch": graph_mismatch(out, g, w_ref, inp.weights)}

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
            pb = sssp_parent_invalid(g, w_ref, parent, ref, root,
                                     chains=inp.weights.ZERO_WEIGHTS)
            lb = distance_mismatch(inp.weights, level, ref)
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
