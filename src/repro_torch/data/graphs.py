"""Synthetic graph families beyond Kronecker (the SSSP kernel's test beds),
and the GNN cells' graphs.

Counterpart of ``repro.data.graphs``.  Both are drawn with numpy's ``default_rng``, so a
seed gives the same edges as the JAX package's, and the same edges on
every device (torch's CPU and CUDA generators do not share a stream):

  * :func:`grid_graph` — a 2-D grid (road-like): diameter O(side), tiny
    frontiers, hundreds of δ-stepping buckets;
  * :func:`erdos_renyi_graph` — G(n, M) with uniform degree: no heavy tail,
    so the degree sort and heavy core get a graph they cannot help.

Both return the port's :class:`~repro_torch.core.kronecker.EdgeList`, ready
for ``build_csr`` -> ``edge_view`` -> ``compile_plan``.

The GNN cells' graphs (:class:`~repro_torch.models.gnn.Graph`):

  * :func:`make_feature_graph` — a Kronecker graph, degree-sorted (T2), with
    class-conditioned gaussian features and labels.  Its structure is the
    port's ``generate_edges`` -> ``build_csr`` -> ``degree_reorder`` ->
    ``relabel_edges`` -> ``csr_to_edge_arrays`` (:func:`feature_graph_structure`,
    bit for bit the JAX package's on the same edge list); labels, features
    and edge vectors are drawn on a ``torch.Generator``, where the JAX
    package draws with ``jax.random`` (so the values differ);
  * :func:`make_molecule_batch` and :func:`build_triplets` — numpy code
    copied from the JAX package (``default_rng``), bit for bit its arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph_build import CSRGraph, build_csr, csr_to_edge_arrays
from repro_torch.core.kronecker import EdgeList, generate_edges
from repro_torch.core.reorder import degree_reorder, relabel_edges
from repro_torch.models.gnn import Graph
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


def feature_graph_structure(edges: EdgeList, degree_sort: bool = True):
    """The CSR and the edge arrays ``(src, dst, valid)`` of
    :func:`make_feature_graph` from its edge list: built, degree-sorted and
    rebuilt (``degree_sort``), in CSR order."""
    g = build_csr(edges)
    if degree_sort:
        g = build_csr(relabel_edges(edges, degree_reorder(g.degree)))
    src, dst, valid = csr_to_edge_arrays(g)
    return g, src, dst, valid


def make_feature_graph(seed: int, scale: int, d_feat: int, n_classes: int = 8,
                       edge_factor: int = 8, degree_sort: bool = True,
                       with_edge_vec: bool = False, device=None
                       ) -> tuple[Graph, torch.Tensor]:
    """Kronecker graph + gaussian class-conditioned features + int32 labels."""
    device = resolve_device(device)
    g, src, dst, valid = feature_graph_structure(
        generate_edges(seed, scale, edge_factor, device=device), degree_sort)
    n = g.num_vertices
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=device,
                           dtype=torch.int32)
    centers = torch.randn((n_classes, d_feat), generator=gen, device=device)
    feat = centers[labels.long()] + 0.5 * torch.randn((n, d_feat), generator=gen,
                                                      device=device)
    ev = None
    if with_edge_vec:
        ev = torch.randn((src.shape[0], 3), generator=gen, device=device)
    return Graph(node_feat=feat, edge_src=src, edge_dst=dst, edge_valid=valid,
                 n_nodes=n, edge_vec=ev), labels


def csr_of(g: Graph) -> tuple[torch.Tensor, torch.Tensor]:
    """``(row_offsets, col_indices)`` of a graph whose edge arrays are in CSR
    order (:func:`make_feature_graph`'s), for the neighbour sampler."""
    deg = torch.bincount(g.edge_src[g.edge_valid].long(), minlength=g.n_nodes)
    ro = torch.cat([deg.new_zeros(1), torch.cumsum(deg, 0)]).to(torch.int32)
    return ro, g.edge_dst


def make_molecule_batch(seed: int, n_mols: int, nodes_per_mol: int,
                        edges_per_mol: int, n_species: int = 16, device=None
                        ) -> tuple[Graph, torch.Tensor, dict]:
    """Batched small molecular graphs (random geometric) + triplet lists.

    Returns (graph with graph_ids, species, triplets dict for DimeNet).
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = n_mols * nodes_per_mol
    e = n_mols * edges_per_mol
    pos = rng.normal(size=(n_mols, nodes_per_mol, 3)) * 1.5
    src = np.empty(e, np.int32)
    dst = np.empty(e, np.int32)
    vec = np.empty((e, 3), np.float32)
    for m in range(n_mols):
        # connect nearest neighbours until edges_per_mol directed edges
        d = np.linalg.norm(pos[m][:, None] - pos[m][None], axis=-1)
        np.fill_diagonal(d, np.inf)
        order = np.argsort(d, axis=1)
        cnt = 0
        k = 0
        while cnt < edges_per_mol:
            for i in range(nodes_per_mol):
                if cnt >= edges_per_mol:
                    break
                j = order[i, k % (nodes_per_mol - 1)]
                idx = m * edges_per_mol + cnt
                src[idx] = m * nodes_per_mol + i
                dst[idx] = m * nodes_per_mol + j
                vec[idx] = pos[m, j] - pos[m, i]
                cnt += 1
            k += 1
    species = rng.integers(0, n_species, size=n).astype(np.int32)
    graph_ids = np.repeat(np.arange(n_mols, dtype=np.int32), nodes_per_mol)

    def t(a):
        return torch.from_numpy(a).to(device)

    graph = Graph(node_feat=torch.zeros((n, 1), device=device), edge_src=t(src),
                  edge_dst=t(dst), edge_valid=torch.ones((e,), dtype=torch.bool,
                                                         device=device),
                  n_nodes=n, edge_vec=t(vec), graph_ids=t(graph_ids))
    triplets = build_triplets(src, dst, vec, max_triplets=e * 8, device=device)
    return graph, t(species), triplets


def build_triplets(src: np.ndarray, dst: np.ndarray, vec: np.ndarray,
                   max_triplets: int, device=None) -> dict:
    """DimeNet triplet lists: pairs of edges (k->j, j->i), k != i.

    angle[t] = angle between vec(j->k reversed) and vec(j->i) at pivot j.
    Static-size output: padded with valid=False.
    """
    device = resolve_device(device)
    e = len(src)
    by_src: dict[int, list[int]] = {}
    for eid in range(e):
        by_src.setdefault(int(src[eid]), []).append(eid)
    t_in, t_out, ang = [], [], []
    for e_out in range(e):  # edge j -> i
        j, i = int(src[e_out]), int(dst[e_out])
        for e_in in by_src.get(j, []):  # edge j -> k reversed means k -> j
            k = int(dst[e_in])
            if k == i or e_in == e_out:
                continue
            # incoming edge to j is (k -> j): use reverse of (j -> k)
            v1 = -vec[e_in]
            v2 = vec[e_out]
            cos = float(np.dot(v1, v2) /
                        (np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-9))
            t_in.append(e_in)
            t_out.append(e_out)
            ang.append(np.arccos(np.clip(cos, -1, 1)))
            if len(t_in) >= max_triplets:
                break
        if len(t_in) >= max_triplets:
            break
    pad = max_triplets - len(t_in)
    valid = np.array([True] * len(t_in) + [False] * pad)
    t_in = np.array(t_in + [0] * pad, np.int32)
    t_out = np.array(t_out + [0] * pad, np.int32)
    ang = np.array(ang + [0.0] * pad, np.float32)
    return {k: torch.from_numpy(a).to(device) for k, a in
            (("t_in", t_in), ("t_out", t_out), ("angle", ang), ("valid", valid))}
