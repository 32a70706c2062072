"""The port's SSSP with the Graph500 specification's Kernel 3 weights: float32
reals uniform in [0, 1) (``Graph500Config(real_weights=True)``), on the CPU.

The weight plane is the benchmark's ``uniform_f32`` definition bit for bit;
the distances of ``pipeline.build`` -> ``compile_plan`` -> ``bfs`` equal a
plain float32 Bellman-Ford (``sssp_real_reference.py``, which imports nothing
of the port) bit for bit, at scales 9 to 12 and several seeds; every parent
chain reaches the key, also on hand-built graphs where fl(d + w) == d, where
the integer engines' tie rule would close a cycle; the relax's plain version
equals a loop over the entries; validation fails a zero-weight 2-cycle of
parents; and a search cut at the round bound fails its sentinel.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import graph_build, sssp_steps
from repro_torch.core.bfs_steps import EdgeView, edge_view, with_edge_weights
from repro_torch.core.graph_build import build_csr
from repro_torch.core.hybrid_bfs import SENTINEL_OK, BFSResult
from repro_torch.core.kronecker import EdgeList
from repro_torch.core.pipeline import Graph500Config, build, search_keys
from repro_torch.core.plan import PreparedGraph, TraversalPlan, compile_plan
from repro_torch.core.validate import validate_sssp
from repro_torch.kernels import ops, ref

from sssp_real_reference import bellman_ford_f32, chains_reach, least_source_parents

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)
ULP = 2.0 ** -24
F32 = torch.float32


def plane_f32(ev: EdgeView) -> torch.Tensor:
    return ev.weight.to(torch.int32).view(F32)


def distances(res) -> torch.Tensor:
    """float32 [V] of a result's distance plane, +inf where unreached."""
    return torch.where(res.level >= 0, res.level.view(F32), float("inf"))


def assert_sound(ev, res, root):
    """Distances bit for bit those of the plain Bellman-Ford, every chain of
    parents to the key, the five checks and the sentinels."""
    valid = ev.valid
    want = bellman_ford_f32(ev.src[valid], ev.dst[valid], plane_f32(ev)[valid],
                            ev.num_vertices, root)
    got = distances(res)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    reached = res.parent >= 0
    assert torch.equal(reached, torch.isfinite(want))
    assert bool(chains_reach(res.parent, root)[reached].all())
    assert bool(validate_sssp(ev, res, root).ok)
    n = int(res.stats.levels)
    assert (res.stats.sentinel[:n] == SENTINEL_OK).all()


# ---------------------------------------------------------------------------
# The weight plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 2, 2**32 + 5, 2**40 + 3])
def test_real_weights_are_the_benchmarks_uniform_f32(seed):
    from portbench.bench.spec import Benchmark
    real = Benchmark(ROOT).weights("uniform_f32")
    rng = np.random.default_rng(seed % 1000)
    n = 20000
    src = rng.integers(0, 2**31, n).astype(np.int32)
    dst = rng.integers(0, 2**31, n).astype(np.int32)
    src[:50] = 2**31 - 1 - np.arange(50)            # ids near 2^31
    valid = rng.random(n) < 0.9
    s, d, va = map(torch.from_numpy, (src, dst, valid))
    got = graph_build.edge_weights(s, d, va, seed=seed, real=True)
    assert got.dtype == torch.int64
    want = real.reference(s.long(), d.long(), seed=seed, doc={})
    assert torch.equal(real.decode_weights(got)[va], want[va])
    assert torch.equal(got[~va], torch.zeros_like(got[~va]))
    assert torch.equal(got, graph_build.edge_weights(d, s, va, seed=seed, real=True))
    w = real.decode_weights(got)[va]
    assert float(w.min()) >= 0.0 and float(w.max()) < 1.0
    # the integer plane of the same hash is untouched by the option
    assert torch.equal(graph_build.edge_weights(s, d, va, seed=seed),
                       graph_build.edge_weights(s, d, va, seed=seed, real=False))


def test_the_option_weighs_sssp_only_and_runs_on_one_device_or_root_lanes():
    with pytest.raises(ValueError, match="real_weights"):
        build(Graph500Config(scale=8, real_weights=True, device="cpu"))
    cfg = Graph500Config(scale=8, kernel="sssp", heavy_threshold=None,
                         real_weights=True, device="cpu")
    b = build(cfg)
    assert b.ev.real_weights and not build(Graph500Config(
        scale=8, kernel="sssp", heavy_threshold=None, device="cpu")).ev.real_weights
    from repro_torch.comms.mesh import make_mesh
    mesh = make_mesh((2, 2), ("group", "member"), device="cpu", virtual=True)
    with pytest.raises(ValueError, match="real weights"):
        compile_plan(TraversalPlan(layout=("group", "member"), kernel="sssp"), b,
                     device="cpu", mesh=mesh)


@pytest.mark.parametrize("mean_degree,delta", [
    (0.2, 1.0), (2.0, 1.0), (30.0, 1.0), (50.0, 0.5), (58.7, 0.5), (100.0, 0.25),
    (200.0, 0.125), (1e4, 2.0 ** -8)])
def test_the_real_delta_is_a_power_of_two_over_the_degree(mean_degree, delta):
    assert sssp_steps.real_bucket_width(mean_degree) == delta
    assert delta == min(1.0, 2.0 ** round(np.log2(sssp_steps.REAL_DELTA_DEGREES / mean_degree)))


# ---------------------------------------------------------------------------
# Kronecker graphs through the pipeline
# ---------------------------------------------------------------------------

_BUILT: dict = {}


def real_graph(scale, seed):
    if (scale, seed) not in _BUILT:
        cfg = Graph500Config(scale=scale, seed=seed, n_roots=4, kernel="sssp",
                             heavy_threshold=None, real_weights=True, device="cpu")
        b = build(cfg)
        _BUILT[(scale, seed)] = (cfg, b, compile_plan(cfg.to_plan(), b, device="cpu"),
                                 [int(r) for r in search_keys(cfg, b)])
    return _BUILT[(scale, seed)]


@pytest.mark.parametrize("scale", [9, 10, 11, 12])
@pytest.mark.parametrize("seed", [3, 2**31 + 11, 2**33 + 7])
def test_real_sssp_equals_float32_bellman_ford(scale, seed):
    _, b, c, roots = real_graph(scale, seed)
    assert c.graph.rows.weight.dtype is F32 and c.delta == sssp_steps.real_bucket_width(
        int(b.degree.sum()) / int((b.degree > 0).sum()))
    for r in roots:
        assert_sound(b.ev, c.bfs(r), r)


@pytest.mark.parametrize("scale", [9, 12])
def test_real_sssp_batched_equals_per_root(scale):
    cfg, b, c, roots = real_graph(scale, 5)
    batched = compile_plan(TraversalPlan(kernel="sssp", batch_roots=True), b,
                           device="cpu").bfs(roots)
    for i, r in enumerate(roots):
        one = c.bfs(r)
        assert torch.equal(batched.parent[i], one.parent)
        assert torch.equal(batched.level[i], one.level)


def test_checked_run_of_real_weights_validates_every_root():
    cfg, b, c, roots = real_graph(10, 3)
    out = c.run(roots, check="full")
    assert out.run.check_failures == {} and out.run.quarantined == []
    assert all(out.run.validated)


# ---------------------------------------------------------------------------
# Ties where fl(d + w) == d
# ---------------------------------------------------------------------------

#: root 5; 5-4-3-2 at 0.75 each puts vertex 2 at 2.25 (parent 3), where an
#: ulp is 2^-22; then a zero weight (2-0, and 0-6-7 on), and one of 2^-24,
#: under half an ulp (2-1): each end of these sits at 2.25 too.
PATH = [(5, 4, 0.75), (4, 3, 0.75), (3, 2, 0.75)]
TIES = {"zero": [(2, 0, 0.0), (0, 6, 0.0), (6, 7, 0.0)],
        "half_ulp": [(2, 1, ULP)],
        "both": [(2, 0, 0.0), (0, 6, 0.0), (6, 7, 0.0), (2, 1, ULP), (0, 1, ULP)]}


def tie_graph(kind):
    edges = PATH + TIES[kind]
    n = 8
    el = EdgeList(src=torch.tensor([a for a, _, _ in edges], dtype=torch.int32),
                  dst=torch.tensor([b for _, b, _ in edges], dtype=torch.int32),
                  num_vertices=n)
    g = build_csr(el)
    ev = edge_view(g)
    w = torch.zeros(ev.src.shape[0], dtype=F32)
    for a, b, x in edges:
        both = ((ev.src == a) & (ev.dst == b)) | ((ev.src == b) & (ev.dst == a))
        w[both & ev.valid] = x
    ev = EdgeView(ev.src, ev.dst, ev.valid, n, w.view(torch.int32).to(torch.int64), True)
    return ev, g.degree


@pytest.mark.parametrize("kind", sorted(TIES))
def test_ties_where_the_add_does_not_raise_the_distance_keep_a_tree(kind):
    ev, degree = tie_graph(kind)
    root, d = 5, np.float32(2.25)
    assert np.float32(d + np.float32(ULP)) == d and np.float32(d + np.float32(0)) == d
    valid = ev.valid
    want = bellman_ford_f32(ev.src[valid], ev.dst[valid], plane_f32(ev)[valid], 8, root)
    # the integer engines' rule, the least source whose sum ties, closes a cycle
    old = least_source_parents(ev.src[valid], ev.dst[valid], plane_f32(ev)[valid], want, root)
    assert not bool(chains_reach(old, root)[torch.isfinite(want)].all())
    for batch in (False, True):
        c = compile_plan(TraversalPlan(kernel="sssp", batch_roots=batch),
                         PreparedGraph(ev=ev, degree=degree), device="cpu")
        if batch:
            rows = c.bfs([root])
            res = BFSResult(rows.parent[0], rows.level[0],
                            type(rows.stats)(*(x[0] for x in rows.stats)))
        else:
            res = c.bfs(root)
        assert_sound(ev, res, root)
        assert int(res.parent[2]) == 3          # the one strictly nearer the key
        assert int((distances(res) == 2.25).sum()) == int((want == 2.25).sum()) >= 2


def test_validation_fails_a_zero_weight_two_cycle_and_passes_the_sound_answer():
    ev, degree = tie_graph("both")
    c = compile_plan(TraversalPlan(kernel="sssp", batch_roots=False),
                     PreparedGraph(ev=ev, degree=degree), device="cpu")
    res = c.bfs(5)
    good = validate_sssp(ev, res, 5)
    assert bool(good.ok)
    # 0 and 2 at one distance across a zero weight: each the other's parent
    parent = res.parent.clone()
    parent[0], parent[2] = 2, 0
    bad = validate_sssp(ev, BFSResult(parent, res.level, None), 5)
    assert not bool(bad.ok) and not bool(bad.tree_dist_ok)
    assert bool(bad.tree_edge_ok) and bool(bad.no_shorter_edge_ok) and bool(bad.root_ok)
    # a distance an ulp off fails too
    level = res.level.clone()
    level[7] += 1
    assert not bool(validate_sssp(ev, BFSResult(res.parent, level, None), 5).ok)


# ---------------------------------------------------------------------------
# The relax's plain version, entry by entry
# ---------------------------------------------------------------------------

def relax_operands(seed, v=300):
    """A round's operands: a random graph's rows with zero, sub-ulp and
    ordinary weights; distances from a few values (ties; 2.25 and 3.0 where
    2^-24 vanishes), some unreached; hop counts up to the field's maximum."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, v).astype(np.int32)
    n = int(deg.sum())
    dst = rng.integers(0, v, n).astype(np.int32)
    kind = rng.random(n)
    units = np.where(kind < 0.2, 0, np.where(kind < 0.4, 1, rng.integers(0, 2**24, n)))
    w = (units * ULP).astype(np.float32)
    pbits, hmax = ref.real_key_bits(v)
    dist = rng.choice(np.array([0.0, 0.5, 2.25, 2.25 + 2**-22, 3.0, 0.125], np.float32), v)
    dbits = dist.view(np.uint32).astype(np.uint64)
    unreached = rng.random(v) < 0.2
    hops = rng.integers(0, 4, v).astype(np.uint64)
    hops[rng.random(v) < 0.1] = hmax
    low = (hops << np.uint64(pbits)) | rng.integers(0, v, v).astype(np.uint64)
    key = np.where(unreached, (np.uint64(0xFFFFFFFF) << np.uint64(32)) | np.uint64(v),
                   (dbits << np.uint64(32)) | low)
    front = (rng.random(v) < 0.5) & ~unreached
    return (torch.from_numpy(key.view(np.int64)),
            torch.from_numpy(rng.random(v) < 0.1) & ~torch.from_numpy(front),
            torch.from_numpy(np.where(front, deg, 0).astype(np.int32)),
            torch.from_numpy(np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int64)),
            torch.from_numpy(dst), torch.from_numpy(w))


def relax_by_entry(state, changed, front_deg, row_start, dst, weight):
    """The rule one entry at a time, on the host's uint64 keys."""
    v = state.shape[0]
    pbits, hmax = ref.real_key_bits(v)
    start = [int(k) & (2**64 - 1) for k in state.tolist()]
    new, ch = list(start), changed.tolist()
    wf = weight.numpy()
    for u in range(v):
        du = start[u] >> 32
        for e in range(int(row_start[u]), int(row_start[u]) + int(front_deg[u])):
            nd = int(np.float32(np.uint32(du).view(np.float32) + wf[e]).view(np.uint32))
            hops = min(((start[u] & 0xFFFFFFFF) >> pbits) + 1, hmax)
            cand = nd << 32 | ((hops << pbits | u) if nd == du else u)
            t = int(dst[e])
            new[t] = min(new[t], cand)
    for t in range(v):
        ch[t] = ch[t] or (new[t] >> 32) < (start[t] >> 32)
    return (torch.tensor([k - 2**64 if k >= 2**63 else k for k in new], dtype=torch.int64),
            torch.tensor(ch))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_float_relax_equals_a_loop_over_the_entries(seed):
    state, changed, front_deg, row_start, dst, weight = relax_operands(seed)
    want_s, want_c = relax_by_entry(state, changed, front_deg, row_start, dst, weight)
    st, ch = state.clone(), changed.clone()
    ops.sssp_relax(st, ch, front_deg, row_start, dst, weight)
    assert torch.equal(st, want_s) and torch.equal(ch, want_c)
    assert not torch.equal(st, state)
    # some candidates tied their source's distance and kept a hop count
    pbits, hmax = ref.real_key_bits(state.shape[0])
    hops = ((st & 0xFFFFFFFF) >> pbits)
    assert int(((hops > 0) & (st != state)).sum()) > 0


# ---------------------------------------------------------------------------
# The sentinels' bound
# ---------------------------------------------------------------------------

def path_graph(n, seed=2):
    el = EdgeList(src=torch.arange(n - 1, dtype=torch.int32),
                  dst=torch.arange(1, n, dtype=torch.int32), num_vertices=n)
    g = build_csr(el)
    return with_edge_weights(edge_view(g), seed=seed, real=True), g.degree


def test_a_search_cut_at_the_round_bound_fails_its_sentinel():
    # 2,000 vertices on a path, a bucket of 0.5 per about a hop: past 512 rounds
    ev, degree = path_graph(2000)
    c = compile_plan(TraversalPlan(kernel="sssp", batch_roots=False),
                     PreparedGraph(ev=ev, degree=degree), device="cpu")
    res = c.bfs(0)
    n = int(res.stats.levels)
    assert n == c.max_rounds == 512
    assert (res.stats.sentinel[:n - 1] == SENTINEL_OK).all()
    assert int(res.stats.sentinel[n - 1]) == SENTINEL_OK - 4
    out = c.run([0], check="full")
    assert "sentinel" in out.run.check_failures[0] and out.run.quarantined == [0]
    # a shorter path ends inside the bound and passes
    ev, degree = path_graph(300)
    c = compile_plan(TraversalPlan(kernel="sssp", batch_roots=False),
                     PreparedGraph(ev=ev, degree=degree), device="cpu")
    assert_sound(ev, c.bfs(0), 0)


def test_a_hop_count_at_its_maximum_fails_the_sentinel(monkeypatch):
    # a 1-bit hop field: a chain of two zero weights saturates it
    ev, degree = tie_graph("zero")
    monkeypatch.setattr(ref, "real_key_bits", lambda v: (31, 1))
    monkeypatch.setattr(sssp_steps, "real_key_bits", lambda v: (31, 1))
    c = compile_plan(TraversalPlan(kernel="sssp", batch_roots=False),
                     PreparedGraph(ev=ev, degree=degree), device="cpu")
    res = c.bfs(5)
    n = int(res.stats.levels)
    assert int(res.stats.sentinel[n - 1]) == SENTINEL_OK - 4
    assert (res.stats.sentinel[:n - 1] == SENTINEL_OK).all()
