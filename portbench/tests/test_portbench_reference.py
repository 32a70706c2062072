"""The plain reference on tiny hand-made graphs, and the comparison's
counts on answers made wrong by hand."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import compare, roofline, teps  # noqa: E402
from portbench.bench.spec import Benchmark  # noqa: E402
from portbench.reference.graph import build_graph  # noqa: E402
from portbench.reference.search import (  # noqa: E402
    bfs_levels, bfs_parents, components, sssp_distances, sssp_parents, traversed_edges,
)
from portbench.reference.weights import edge_weights  # noqa: E402


def _t(xs):
    return torch.tensor(xs, dtype=torch.int32)


# input edges (0-1 twice, a self loop on 2, 1-2, 3-4); vertex 5 isolated
SRC, DST = _t([0, 1, 2, 1, 3]), _t([1, 0, 2, 2, 4])


def test_graph_symmetric_deduped_relabelled_by_degree():
    g = build_graph(SRC, DST, 6)
    # degrees by input id: 0:1 1:2 2:1 3:1 4:1 5:0 -> sorted order 1,0,2,3,4,5
    assert g.new_from_old.tolist() == [1, 0, 2, 3, 4, 5]
    assert g.degree.tolist() == [2, 1, 1, 1, 1, 0]
    pairs = list(zip(g.src.tolist(), g.dst.tolist()))
    assert pairs == [(0, 1), (0, 2), (1, 0), (2, 0), (3, 4), (4, 3)]
    assert g.nnz == 6
    found, pos = g.edge_index(torch.tensor([0, 4, 1]), torch.tensor([2, 3, 2]))
    assert found.tolist() == [True, True, False]
    assert pos[:2].tolist() == [1, 5]


def test_graph_without_dedupe_keeps_duplicates():
    g = build_graph(SRC, DST, 6, dedupe=False)
    assert g.nnz == 8 and int(g.degree.sum()) == 8


def test_bfs_levels_parents_and_edges():
    g = build_graph(SRC, DST, 6)
    lev = bfs_levels(g, 1)           # sorted id 1 is input vertex 0
    assert lev.tolist() == [1, 0, 2, -1, -1, -1]
    assert bfs_parents(g, lev, 1).tolist() == [1, 1, 0, -1, -1, -1]
    lab = components(g)
    assert lab.tolist() == [0, 0, 0, 3, 3, 5]
    assert traversed_edges(g, lab, torch.tensor([1, 3, 5])).tolist() == [2, 1, 0]


def test_sssp_takes_the_lighter_path():
    # the square 0-1-2-3-0 with the diagonal 0-2; by degree the sorted ids
    # are 0->0, 2->1, 1->2, 3->3, so the diagonal is sorted pair (0, 1)
    g = build_graph(_t([0, 1, 2, 3, 0]), _t([1, 2, 3, 0, 2]), 4)
    assert g.new_from_old.tolist() == [0, 2, 1, 3]
    w = torch.ones(g.nnz, dtype=torch.int64)
    w[(torch.minimum(g.src, g.dst) == 0) & (torch.maximum(g.src, g.dst) == 1)] = 5
    d = sssp_distances(g, w, 0)
    assert d.tolist() == [0, 2, 1, 1]
    assert sssp_parents(g, w, d, 0).tolist() == [0, 2, 0, 0]


def test_weights_symmetric_in_range_and_the_control_step():
    u = torch.arange(0, 2000)
    v = torch.flip(u, [0])
    w = edge_weights(u, v, seed=2**33 + 5, max_weight=255)
    assert torch.equal(w, edge_weights(v, u, seed=2**33 + 5, max_weight=255))
    assert int(w.min()) >= 1 and int(w.max()) <= 255
    w4 = edge_weights(u, v, seed=2**33 + 5, max_weight=255, bits=4)
    assert bool(((w4 & 15) == 15).all()) and not torch.equal(w, w4)


def _outputs(g, kernel, root, level, parent, m, weight=None):
    return compare.Outputs(nnz=g.nnz, src=g.src, dst=g.dst, degree=g.degree,
                           weight=weight, search_keys=[0], search_edges=[m],
                           checked=[(0, 0, parent, level)],
                           search_roots=[(int(parent[root]), int(level[root]))])


def test_comparison_counts_each_kind_of_fault():
    inp = compare.Inputs(src=SRC, dst=DST, num_vertices=6, keys=torch.tensor([0]),
                         kernel="bfs", seed=1)
    g = build_graph(SRC, DST, 6)
    lev = bfs_levels(g, 1)
    par = bfs_parents(g, lev, 1)
    good = compare.compare(_outputs(g, "bfs", 1, lev, par, 2), inp)
    assert good["numbers"] == {k: 0 for k in compare.LIMITS} and good["failed"] == 0
    assert compare.verdict(good["numbers"])
    bad_lev = lev.clone()
    bad_lev[2] = 5
    r = compare.compare(_outputs(g, "bfs", 1, bad_lev, par, 2), inp)["numbers"]
    assert r["level_mismatch"] == 1
    bad_par = par.clone()
    bad_par[2] = 2
    r = compare.compare(_outputs(g, "bfs", 1, lev, bad_par, 2), inp)["numbers"]
    assert r["parent_invalid"] == 1
    bad_root = par.clone()
    bad_root[1] = 0
    r = compare.compare(_outputs(g, "bfs", 1, lev, bad_root, 2), inp)["numbers"]
    assert r["root_invalid"] == 1 and r["parent_invalid"] >= 1
    r = compare.compare(_outputs(g, "bfs", 1, lev, par, 3), inp)["numbers"]
    assert r["edges_mismatch"] == 1 and not compare.verdict(r)
    out = _outputs(g, "bfs", 1, lev, par, 2)
    out.degree = out.degree.clone()
    out.degree[0] += 1
    assert compare.compare(out, inp)["numbers"]["graph_mismatch"] == 1


def test_sssp_comparison_checks_weights():
    inp = compare.Inputs(src=SRC, dst=DST, num_vertices=6, keys=torch.tensor([0]),
                         kernel="sssp", seed=9, weights=Benchmark(ROOT).weights("hash_int"),
                         doc={"max_weight": 255})
    g = build_graph(SRC, DST, 6)
    w = edge_weights(g.src, g.dst, seed=9, max_weight=255)
    d = sssp_distances(g, w, 1)
    p = sssp_parents(g, w, d, 1)
    good = compare.compare(_outputs(g, "sssp", 1, d, p, 2, weight=w), inp)
    assert good["numbers"] == {k: 0 for k in compare.LIMITS}
    w2 = w.clone()
    w2[0] += 1
    bad = compare.compare(_outputs(g, "sssp", 1, d, p, 2, weight=w2), inp)
    assert bad["numbers"]["graph_mismatch"] == 1


def test_teps_arithmetic():
    deg = torch.tensor([2, 1, 1, 0], dtype=torch.int32)
    assert int(teps.traversed_edges(deg, torch.tensor([0, 0, 1, -1]))) == 2
    assert teps.harmonic_mean_teps([10, 10], [1.0, 0.5]) == pytest.approx(2 / (0.1 + 0.05))
    assert teps.harmonic_mean_teps([0], [1.0]) == 0.0


def test_core_spmv_bytes_follow_the_first_hit():
    words = 8
    out = torch.tensor([0, 32 * 3 + 5, roofline.BIG], dtype=torch.int32)
    need = 1 + 4 + 8
    expect = max(4 * (need + 8 + 3) / roofline.HBM_BYTES_PER_S,
                 5 * need / roofline.SCALAR_OPS_PER_S)
    assert roofline.core_spmv_bound_s(out, words) == pytest.approx(expect)
    assert roofline.frontier_update_bound_s(1024) == pytest.approx(
        (16 * 1024 + 4) / roofline.HBM_BYTES_PER_S)


def test_sssp_relax_bytes_are_the_scan_and_the_frontier_rows():
    # two rounds over 1,000 vertices whose frontiers hold 5,000 entries
    assert roofline.sssp_relax_bound_s(5000, 2, 1000) == pytest.approx(
        (4 * 1000 * 2 + 8 * 5000) / roofline.HBM_BYTES_PER_S)
    # scale 22, a search's 21 rounds over its 420,937,999 entries: about 1.1 ms
    assert 1.0e-3 < roofline.sssp_relax_bound_s(420_937_999, 21, 1 << 22) < 1.2e-3
