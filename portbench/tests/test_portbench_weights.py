"""Weight schemes (``portbench/weights/``): ``hash_int`` is the accepted
configurations' weights bit for bit; ``uniform_f32`` is the specification's
reals at float32, its reference exact in float32 sums, and the comparison
holds a program to it; a configuration that names a scheme runs through the
harness with no edit to it."""
import heapq
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import cell, compare, inputs  # noqa: E402
from portbench.bench.control import run_control  # noqa: E402
from portbench.bench.spec import Benchmark  # noqa: E402
from portbench.reference.graph import build_graph  # noqa: E402
from portbench.reference.search import (  # noqa: E402
    components, sssp_distances, sssp_parents, traversed_edges,
)
from portbench.reference.weights import edge_weights  # noqa: E402

BENCH = Benchmark(ROOT)
HASH, REAL = BENCH.weights("hash_int"), BENCH.weights("uniform_f32")
ULP = 2.0 ** -24
# the scale-9 Kronecker graph of seed 5, whose weights under seed 22 put a
# zero on the entries between sorted ids 99 and 115, in its largest component
GRAPH_SEED, WEIGHT_SEED, ZERO_EDGE = 5, 22, (99, 115)


def _scale9():
    src, dst = inputs.kronecker_edges(GRAPH_SEED, 9, 16, 0.57, 0.19, 0.19, "cpu")
    return src, dst, build_graph(src, dst, 512)


def test_edge_weights_keep_their_values():
    u = torch.tensor([0, 1, 5, 77, 4194303, 123456])
    v = torch.tensor([3, 0, 5, 76, 2, 654321])
    assert edge_weights(u, v, seed=2, max_weight=255).tolist() == [65, 44, 31, 41, 18, 177]
    assert edge_weights(u, v, seed=2**33 + 5, max_weight=255, bits=4).tolist() == [
        191, 207, 63, 31, 95, 47]
    assert edge_weights(u, v, seed=3300000101, max_weight=255).tolist() == [
        80, 211, 104, 230, 88, 71]


@pytest.mark.parametrize("seed", [2, 2**31 + 77, 2**40 + 3])
@pytest.mark.parametrize("control", [False, True])
def test_hash_int_is_edge_weights_bit_for_bit(seed, control):
    u = torch.randint(0, 1 << 22, (5000,), generator=torch.Generator().manual_seed(seed % 97))
    v = torch.flip(u, [0])
    w = HASH.reference(u, v, seed=seed, doc={"max_weight": 255}, control=control)
    assert w.dtype == torch.int64
    assert torch.equal(w, edge_weights(u, v, seed=seed, max_weight=255,
                                       bits=4 if control else None))
    assert torch.equal(HASH.decode_weights(w.to(torch.int32)), w)


@pytest.mark.parametrize("config", ["g500-bfs-s22", "g500-sssp-s22"])
def test_the_accepted_configurations_resolve_to_hash_int(config):
    doc = BENCH.config(config)
    assert "weights" not in doc
    assert BENCH.weights(doc.get("weights")).__file__ == HASH.__file__


def test_uniform_f32_reals_in_0_1_at_float32():
    u = torch.arange(0, 20000)
    v = (u * 7919 + 13) % 50000
    w = REAL.reference(u, v, seed=2**33 + 5, doc={})
    assert w.dtype == torch.float32
    assert torch.equal(w, REAL.reference(v, u, seed=2**33 + 5, doc={}))
    assert float(w.min()) >= 0.0 and float(w.max()) < 1.0
    units = w.double() / ULP
    assert torch.equal(units, units.round())
    assert float(w.max()) > 0.99 and float(w.min()) < 0.01
    assert float(w.double().mean()) == pytest.approx(0.5, abs=0.01)
    assert not torch.equal(w, REAL.reference(u, v, seed=2**33 + 6, doc={}))
    b = REAL.reference(u, v, seed=2**33 + 5, doc={}, control=True)
    assert torch.equal(b, w.to(torch.bfloat16).float()) and not torch.equal(b, w)


def test_uniform_f32_planes_round_trip():
    w = REAL.reference(torch.arange(100), torch.arange(100, 200), seed=3, doc={})
    plane = REAL.encode_weights(w)
    assert plane.dtype == torch.int32 and torch.equal(REAL.decode_weights(plane), w)
    assert torch.equal(REAL.decode_weights(plane.to(torch.int64) & 0xFFFFFFFF), w)
    dist = torch.tensor([0.0, 0.75, float("inf")])
    level = REAL.encode_distances(dist)
    assert level.tolist()[2] == -1 and level.tolist()[0] == 0
    got, reached = REAL.decode_distances(level)
    assert reached.tolist() == [True, True, False]
    assert torch.equal(got[:2], dist[:2])


def _dijkstra_f32(g, w, root):
    """Heap-ordered Dijkstra on the host, each relaxation a float32 add."""
    src, dst, wt = g.src.numpy(), g.dst.numpy(), w.numpy().astype(np.float32)
    starts = np.searchsorted(src, np.arange(g.num_vertices + 1))
    dist = np.full(g.num_vertices, np.inf, np.float32)
    dist[root] = np.float32(0)
    done = np.zeros(g.num_vertices, bool)
    heap = [(np.float32(0), root)]
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for i in range(starts[u], starts[u + 1]):
            nd = np.float32(d + wt[i])
            if nd < dist[dst[i]]:
                dist[dst[i]] = nd
                heapq.heappush(heap, (nd, int(dst[i])))
    return dist


@pytest.mark.parametrize("root", [0, 1, 17, 200])
def test_the_float_reference_is_dijkstra_in_float32(root):
    _, _, g = _scale9()
    w = REAL.reference(g.src, g.dst, seed=2**31 + 9, doc={})
    got = sssp_distances(g, w, root)
    assert got.dtype == torch.float32
    want = _dijkstra_f32(g, w, root)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def _weighted(pairs, n):
    """A hand-made graph of ``(a, b, units of 2^-24)`` edges and its
    per-entry float32 weights."""
    g = build_graph(torch.tensor([a for a, _, _ in pairs], dtype=torch.int32),
                    torch.tensor([b for _, b, _ in pairs], dtype=torch.int32), n)
    w = torch.zeros(g.nnz, dtype=torch.float32)
    for a, b, units in pairs:
        x, y = int(g.new_from_old[a]), int(g.new_from_old[b])
        w[((g.src == x) & (g.dst == y)) | ((g.src == y) & (g.dst == x))] = units * ULP
    return g, w


def test_real_sums_that_tie_and_float32_folds_that_do_not():
    # 0-1-2-5 and 0-3-4-5 carry the same three weights in another order: the
    # same real sum, and float32 folds an ulp apart
    x, y, z = 16486625, 5880938, 9017480
    g, w = _weighted([(0, 1, x), (1, 2, y), (2, 5, z), (0, 3, z), (3, 4, x), (4, 5, y)], 6)

    def fold(units):
        d = np.float32(0)
        for u in units:
            d = np.float32(d + np.float32(u * ULP))
        return d
    a, b = fold([x, y, z]), fold([z, x, y])
    assert b < a
    root, end = int(g.new_from_old[0]), int(g.new_from_old[5])
    dist = sssp_distances(g, w, root)
    assert float(dist[end]) == float(b)
    assert np.array_equal(dist.numpy(), _dijkstra_f32(g, w, root))
    assert int(sssp_parents(g, w, dist, root)[end]) == int(g.new_from_old[4])


def _reference_answers(inp, n):
    """The reference's own answers to the first ``n`` keys, in the program's
    planes."""
    g = build_graph(inp.src, inp.dst, inp.num_vertices)
    roots = g.new_from_old[inp.keys.to(torch.int64)]
    w = inp.weights.reference(g.src, g.dst, seed=inp.seed, doc=inp.doc)
    m = traversed_edges(g, components(g), roots).tolist()
    checked = []
    for i in range(n):
        dist = sssp_distances(g, w, int(roots[i]))
        checked.append((i, i, sssp_parents(g, w, dist, int(roots[i])),
                        inp.weights.encode_distances(dist)))
    return compare.Outputs(nnz=g.nnz, src=g.src, dst=g.dst, degree=g.degree,
                           weight=inp.weights.encode_weights(w), search_keys=list(range(n)),
                           search_edges=m[:n], checked=checked,
                           search_roots=[(int(roots[i]), 0) for i in range(n)]), g, w


def _inputs(keys):
    src, dst, _ = _scale9()
    return compare.Inputs(src=src, dst=dst, num_vertices=512, keys=torch.tensor(keys),
                          kernel="sssp", seed=WEIGHT_SEED, weights=REAL, doc={})


def _zero_key_first():
    """Three keys (input labels), the first the vertex of highest degree, in
    the zero-weight edge's component."""
    src, dst, g = _scale9()
    old_from_new = torch.argsort(g.new_from_old)
    return [int(old_from_new[0]), int(src[0]), int(dst[1])], g


def test_the_float_comparison_reads_0_on_the_reference_and_above_0_on_each_fault():
    keys, g = _zero_key_first()
    inp = _inputs(keys)
    out, g, w = _reference_answers(inp, 3)
    a, b = ZERO_EDGE
    assert float(w[(g.src == a) & (g.dst == b)]) == 0.0     # the zero weight is there
    assert compare.compare(out, inp)["numbers"] == {k: 0 for k in compare.LIMITS}

    # one distance an ulp off
    _, k, parent, level = out.checked[1]
    far = int(torch.argmax(torch.where(level >= 0, level, 0)))
    bad = level.clone()
    bad[far] += 1
    out.checked[1] = (1, k, parent, bad)
    nums = compare.compare(out, inp)["numbers"]
    assert nums["level_mismatch"] == 1 and not compare.verdict(nums)
    out.checked[1] = (1, k, parent, level)

    # one weight an ulp off
    plane = out.weight.clone()
    plane[7] += 1
    good, out.weight = out.weight, plane
    assert compare.compare(out, inp)["numbers"]["graph_mismatch"] == 1
    out.weight = good

    # a parent 2-cycle across the zero-weight edge: each end the other's parent
    _, k, parent, level = out.checked[0]
    assert int(level[a]) == int(level[b]) and int(level[a]) > 0
    cyc = parent.clone()
    cyc[a], cyc[b] = b, a
    out.checked[0] = (0, k, cyc, level)
    nums = compare.compare(out, inp)["numbers"]
    assert nums["parent_invalid"] >= 2 and not compare.verdict(nums)
    # both ends pass the local test, so only the chain check finds them
    ref = sssp_distances(g, w, int(g.new_from_old[keys[0]]))
    assert compare.sssp_parent_invalid(g, w, cyc, ref, int(g.new_from_old[keys[0]])) == 0


def test_the_zero_weight_edge_leaves_the_reference_parents_a_tree():
    keys, g = _zero_key_first()
    inp = _inputs(keys)
    out, g, w = _reference_answers(inp, 1)
    _, _, parent, level = out.checked[0]
    root = int(g.new_from_old[keys[0]])
    reached = level != -1
    up = torch.where(reached, parent, torch.arange(512))
    assert bool(compare.reaches_root(up, root)[reached].all())


def test_the_bf16_control_is_not_correct():
    doc = {**BENCH.config("g500-sssp-s22"), "scale": 9, "search_keys": 16,
           "weights": "uniform_f32"}
    for seed in (2**31 + 77, 2**31 + 78, 2**31 + 79):
        for checked in (False, True):
            res = run_control(doc, REAL, seed, "cpu", 4, checked=checked)
            assert res["correct"] is False
            assert res["numbers"]["graph_mismatch"] > 0


def test_an_unknown_scheme_names_the_missing_file():
    with pytest.raises(FileNotFoundError, match=r"weights/uniform_f16\.py"):
        BENCH.weights("uniform_f16")
    with pytest.raises(ValueError):
        BENCH.weights("../bench/cell")


def test_a_real_weight_configuration_added_as_new_files(tmp_path):
    """``g500-sssp-real-s9`` (``"weights": "uniform_f32"``) and its cell, as
    new files and entries of a copy: the harness takes them unedited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc = json.loads((ROOT / "portbench/configs/g500-sssp-s22.json").read_text())
    del doc["max_weight"]
    doc.update(weights="uniform_f32", scale=9, search_keys=16)
    (tmp_path / "portbench/configs/g500-sssp-real-s9.json").write_text(json.dumps(doc))
    bench["configs"].append({"name": "g500-sssp-real-s9", "source": "a test",
                             "file": "portbench/configs/g500-sssp-real-s9.json",
                             "reduced": ["scale"], "why": "a test"})
    bench["workloads"].append({"name": "sssp-real-s9", "config": "g500-sssp-real-s9",
                               "traffic": "spec_keys", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    b = Benchmark(tmp_path)
    conf = b.config(b.cell("sssp-real-s9").config)
    weights = b.weights(conf.get("weights"))
    assert weights.ZERO_WEIGHTS and not HASH.ZERO_WEIGHTS
    cfg = cell.program_config(conf, conf["graph_seed"], "cpu", weights)
    assert cfg.kernel == "sssp" and cfg.scale == 9

    src, dst = inputs.graph(conf, conf["graph_seed"], "cpu")
    keys = inputs.search_keys(conf["graph_seed"], src, dst, 512, 16)
    inp = compare.Inputs(src=src, dst=dst, num_vertices=512, keys=keys, kernel="sssp",
                         seed=conf["graph_seed"], weights=weights, doc=conf)
    out, _, _ = _reference_answers(inp, 4)
    res = cell._check(conf, conf["graph_seed"], keys, out, "cpu", weights)
    assert res["numbers"] == {k: 0 for k in compare.LIMITS} and res["checked"] == 4
    assert run_control(conf, weights, 2**31 + 5, "cpu", 4)["correct"] is False

    # the program's integer weights are not these: a whole run is not correct
    result, _ = cell.run(tmp_path, "sssp-real-s9", 2**31 + 5, 0.2, False,
                         t_start=time.perf_counter(), device="cpu", require_chip=False)
    assert result["correct"] is False
    assert result["checks"]["graph_mismatch"]["value"] > 0
