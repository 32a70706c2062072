"""Graph500 step 4: BFS tree and SSSP validation (5 checks each).

Counterpart of ``repro.core.validate``.  BFS:

  V1. parent[root] == root, level[root] == 0.
  V2. every visited non-root vertex has a visited parent and
      level[v] == level[parent[v]] + 1  (no cycles, correct depths).
  V3. every tree edge (v, parent[v]) exists in the input graph.
  V4. every graph edge spans levels differing by at most 1.
  V5. both endpoints of every edge are visited iff either is.

SSSP, over ``(parent, dist)`` with ``dist`` in the result's ``level`` plane:
  S1. parent[root] == root, dist[root] == 0.
  S2. every reached non-root vertex v satisfies
      dist[v] == dist[parent[v]] + w(parent[v], v).
  S3. every tree edge (v, parent[v]) exists in the input graph.
  S4. dist[d] <= dist[s] + w(s, d) for every edge with both ends reached.
  S5. component consistency, as V5.

Real weights (the view's ``real_weights``: float32 bit patterns in the
weight plane and the distance plane, -1 unreached) take the same checks
with each sum one float32 add rounded to nearest, and S2 also follows every
reached vertex's chain of parents to the root: a zero weight, or one under
half an ulp of the distance, lets two vertices at one distance pass the
local test as each other's parent.

Gathers at corrupted indices are clamped into range, as JAX clamps them,
and a vertex with no edge entries at all counts as witnessed in V3, as the
JAX ``segment_max`` of an empty segment does; so the per-check booleans
equal the JAX package's on corrupted parents too.  For SSSP the tree-edge
weight of such a vertex is the empty segment's INT32_MIN, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bfs_steps import EdgeView
from repro_torch.core.hybrid_bfs import BFSResult

#: Short names of the five spec checks, in Validation field order.
CHECK_NAMES = ("root", "depth", "tree_edge", "edge_level", "component")


class Validation(NamedTuple):
    ok: torch.Tensor          # [] bool
    root_ok: torch.Tensor
    depth_ok: torch.Tensor
    tree_edge_ok: torch.Tensor
    edge_level_ok: torch.Tensor
    component_ok: torch.Tensor


def _segment_max(values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """int32 max of ``values`` per segment id in ``[0, n)``; INT32_MIN for a
    segment with no entries (``jax.ops.segment_max``)."""
    out = torch.full((n,), -(2**31), dtype=torch.int32, device=values.device)
    return out.scatter_reduce_(0, seg, values, "amax", include_self=False)


def validate(ev: EdgeView, result: BFSResult, root) -> Validation:
    v = ev.num_vertices
    parent, level = result.parent, result.level
    dev = parent.device
    root = int(root)
    visited = parent >= 0
    ids = torch.arange(v, device=dev)

    root_ok = (parent[root] == root) & (level[root] == 0)

    p_safe = torch.where(visited, parent, 0)
    is_root = ids == root
    depth_ok = torch.where(
        visited & ~is_root,
        (parent >= 0) & (parent < v)
        & (level == level[p_safe.clamp(0, v - 1).long()] + 1)
        & (parent != ids),
        True,
    ).all()

    # V3: an edge (s, d) witnesses vertex s's tree edge when d == parent[s].
    p_ext = torch.cat([p_safe, torch.full((1,), -7, dtype=p_safe.dtype, device=dev)])
    witness = ev.valid & (p_ext[ev.src.long()] == ev.dst)
    has_tree_edge = _segment_max(witness.to(torch.int32), ev.src.long(), v + 1)
    tree_edge_ok = torch.where(visited & ~is_root,
                               has_tree_edge[:v].to(torch.bool), True).all()

    lvl_ext = torch.cat([level, torch.full((1,), -1, dtype=level.dtype, device=dev)])
    ls, ld = lvl_ext[ev.src.long()], lvl_ext[ev.dst.long()]
    edge_level_ok = torch.where(ev.valid & (ls >= 0) & (ld >= 0),
                                (ls - ld).abs() <= 1, True).all()

    vis_ext = torch.cat([visited, torch.zeros(1, dtype=torch.bool, device=dev)])
    component_ok = torch.where(ev.valid,
                               vis_ext[ev.src.long()] == vis_ext[ev.dst.long()],
                               True).all()

    ok = root_ok & depth_ok & tree_edge_ok & edge_level_ok & component_ok
    return Validation(ok, root_ok, depth_ok, tree_edge_ok, edge_level_ok,
                      component_ok)


def validate_batch(ev: EdgeView, parents: torch.Tensor, levels: torch.Tensor,
                   roots) -> Validation:
    """All five checks for a ``[R, V]`` batch; every leaf comes back [R] bool."""
    rows = [validate(ev, BFSResult(parent=p, level=l, stats=None), r)
            for p, l, r in zip(parents, levels, roots)]
    return Validation(*(torch.stack(f) for f in zip(*rows)))


#: Short names of the five SSSP invariants, in SsspValidation field order.
SSSP_CHECK_NAMES = ("root", "tree_dist", "tree_edge", "no_shorter_edge",
                    "component")


class SsspValidation(NamedTuple):
    ok: torch.Tensor          # [] bool
    root_ok: torch.Tensor
    tree_dist_ok: torch.Tensor
    tree_edge_ok: torch.Tensor
    no_shorter_edge_ok: torch.Tensor
    component_ok: torch.Tensor


def validate_sssp(ev: EdgeView, result: BFSResult, root) -> SsspValidation:
    """The five SSSP invariants over one ``(parent, dist)`` pair.

    ``ev.weight`` must be attached.  The tree-edge weight comes from the
    same witness scatter as S3 (the CSR is deduped, so at most one edge
    witnesses each ``(v, parent[v])``).  Arithmetic is int32, wrapping as
    JAX's does; float32 for real weights (see the module docstring).
    """
    v = ev.num_vertices
    parent, dist = result.parent, result.level
    dev = parent.device
    root = int(root)
    reached = parent >= 0
    ids = torch.arange(v, device=dev)
    wgt = ev.weight.to(torch.int32)
    src = ev.src.long()

    root_ok = (parent[root] == root) & (dist[root] == 0)

    p_safe = torch.where(reached, parent, 0)
    is_root = ids == root

    p_ext = torch.cat([p_safe, torch.full((1,), -7, dtype=p_safe.dtype, device=dev)])
    witness = ev.valid & (p_ext[src] == ev.dst)
    has_tree_edge = _segment_max(witness.to(torch.int32), src, v + 1)[:v].to(torch.bool)
    w_tree = _segment_max(torch.where(witness, wgt, 0), src, v + 1)[:v]
    tree_edge_ok = torch.where(reached & ~is_root, has_tree_edge, True).all()

    d_par = dist[p_safe.clamp(0, v - 1).long()]
    local = (parent >= 0) & (parent < v) & (parent != ids) & (d_par >= 0)
    dist_ext = torch.cat([dist, torch.full((1,), -1, dtype=dist.dtype, device=dev)])
    ds, dd = dist_ext[src], dist_ext[ev.dst.long()]
    if ev.real_weights:
        f32 = torch.float32
        local &= dist.view(f32) == d_par.view(f32) + w_tree.view(f32)
        up = torch.where(reached & ~is_root & local, parent.long(), ids)
        local &= _reaches(up, root)
        shorter = dd.view(f32) <= ds.view(f32) + wgt.view(f32)
    else:
        local &= dist == d_par + w_tree
        shorter = dd <= ds + wgt
    tree_dist_ok = torch.where(reached & ~is_root, local, True).all()
    no_shorter_edge_ok = torch.where(ev.valid & (ds >= 0) & (dd >= 0), shorter, True).all()

    vis_ext = torch.cat([reached, torch.zeros(1, dtype=torch.bool, device=dev)])
    component_ok = torch.where(ev.valid,
                               vis_ext[src] == vis_ext[ev.dst.long()],
                               True).all()

    ok = (root_ok & tree_dist_ok & tree_edge_ok & no_shorter_edge_ok
          & component_ok)
    return SsspValidation(ok, root_ok, tree_dist_ok, tree_edge_ok,
                          no_shorter_edge_ok, component_ok)


def _reaches(up: torch.Tensor, root: int) -> torch.Tensor:
    """bool [V]: whether each vertex's chain through ``up`` (its parent, or
    itself where the chain stops) reaches ``root``, by pointer jumping:
    after k steps ``up`` is each vertex's 2^k-th ancestor."""
    up = up.clone()
    up[root] = root
    for _ in range(max(1, (up.numel() - 1).bit_length())):
        up = up[up]
    return up == root


def validate_sssp_batch(ev: EdgeView, parents: torch.Tensor, dists: torch.Tensor,
                        roots) -> SsspValidation:
    """The five SSSP invariants for a ``[R, V]`` batch; leaves come back [R]."""
    rows = [validate_sssp(ev, BFSResult(parent=p, level=d, stats=None), r)
            for p, d, r in zip(parents, dists, roots)]
    return SsspValidation(*(torch.stack(f) for f in zip(*rows)))


def failure_report(val):
    """Host-side attribution of a batched Validation or SsspValidation.

    Returns ``(counts, failures)``: ``counts`` maps every check name to the
    number of roots failing it (zeros included), ``failures`` maps each
    failing root *index* to the list of check names it failed.
    """
    names = tuple(f[:-3] for f in val._fields if f.endswith("_ok"))
    per_check = {name: getattr(val, f"{name}_ok").cpu().numpy()
                 for name in names}
    counts = {name: int(np.sum(~okv)) for name, okv in per_check.items()}
    failures: dict[int, list[str]] = {}
    for i in np.nonzero(~val.ok.cpu().numpy())[0]:
        failures[int(i)] = [name for name in names if not per_check[name][i]]
    return counts, failures
