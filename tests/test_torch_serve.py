"""The port's serving subsystem against the JAX package's.

The cache, coalescer, metrics and query trace are numpy-only copies: the
host tests of ``tests/test_serve.py`` run against both packages, and a seed
gives the same trace bit for bit.  The engines then serve the same trace on
the same graph (JAX's arrays carried into the port) with a fixed service
time, so the virtual clock and hence every batch are the same in both:
answers, answer kinds, batch records and cache counters must be equal, and
every answer equal to the offline run of its root, for BFS, for SSSP and
under a root-scoped parent fault.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.data.query_trace as jtrace
import repro.serve.cache as jcache
import repro.serve.coalescer as jcoal
import repro.serve.metrics as jmetrics
from repro.core import build_csr as jax_build_csr
from repro.core import build_heavy_core as jax_build_heavy_core
from repro.core import chunk_edge_view as jax_chunk_edge_view
from repro.core import degree_reorder as jax_degree_reorder
from repro.core import edge_view as jax_edge_view
from repro.core import faults as jfaults
from repro.core import generate_edges as jax_generate_edges
from repro.core import pipeline as jpipe
from repro.core.bfs_steps import with_edge_weights as jax_with_edge_weights
from repro.core.plan import BFSPlan as JaxPlan
from repro.core.plan import PreparedGraph as JaxPrepared
from repro.core.plan import compile_plan as jax_compile
from repro.core.reorder import relabel_edges as jax_relabel_edges
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch.core import faults, pipeline
from repro_torch.core.plan import BFSPlan, PreparedGraph, compile_plan
from repro_torch.data import query_trace
from repro_torch.serve import cache, coalescer, engine, metrics

torch.set_num_threads(2)

V = 16
PKGS = {
    "repro": SimpleNamespace(
        ParentCache=jcache.ParentCache, BatchOutcome=jcoal.BatchOutcome,
        CoalescePolicy=jcoal.CoalescePolicy, Query=jcoal.Query,
        replay=jcoal.replay, ServeReport=jmetrics.ServeReport,
        synth_trace=jtrace.synth_trace),
    "repro_torch": SimpleNamespace(
        ParentCache=cache.ParentCache, BatchOutcome=coalescer.BatchOutcome,
        CoalescePolicy=coalescer.CoalescePolicy, Query=coalescer.Query,
        replay=coalescer.replay, ServeReport=metrics.ServeReport,
        synth_trace=query_trace.synth_trace),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def echo_solver(pkg, fail_roots=(), fail_until_fallback=False, service_s=0.01):
    """Deterministic solve_fn: parent rows are the root id broadcast, so
    any answer can be checked against its root.  ``fail_roots`` rows
    fail every attempt (or only non-fallback attempts)."""
    calls = []

    def solve(padded, n_real, use_fallback):
        calls.append((tuple(int(r) for r in padded), n_real, use_fallback))
        parent = np.tile(padded[:, None], (1, V)).astype(np.int32)
        level = np.full((len(padded), V), 2, np.int32)
        failed = set()
        if not (fail_until_fallback and use_fallback):
            failed = {i for i in range(len(padded))
                      if padded[i] in fail_roots}
        return pkg.BatchOutcome(parent, level, failed_rows=failed,
                                service_s=service_s,
                                check_counts={"tree_edge": len(failed)})

    solve.calls = calls
    return solve


# ---------------------------------------------------------------------------
# Host tests of tests/test_serve.py, on both packages
# ---------------------------------------------------------------------------

def test_cache_lru_eviction_order_and_counters(pkg):
    c = pkg.ParentCache(2)
    p = lambda r: np.full(V, r, np.int32)  # noqa: E731
    c.put(1, p(1), p(1))
    c.put(2, p(2), p(2))
    assert c.get(1) is not None
    c.put(3, p(3), p(3))                 # evicts 2 (LRU), not 1
    assert 2 not in c and 1 in c and 3 in c
    assert c.roots() == [1, 3]
    assert c.get(2) is None
    assert (c.hits, c.misses, c.evictions) == (1, 1, 1)
    assert c.stats()["hit_rate"] == 0.5
    c.put(1, p(1), p(1))                 # a refresh, never an eviction
    assert c.roots() == [3, 1] and c.evictions == 1


def test_cache_hits_bitwise_and_read_only(pkg):
    c = pkg.ParentCache(4)
    parent = np.arange(V, dtype=np.int32)
    c.put(7, parent, parent * 2)
    got = c.get(7)
    assert np.array_equal(got.parent, parent)
    assert np.array_equal(got.level, parent * 2)
    parent[0] = 99
    assert c.get(7).parent[0] == 0
    with pytest.raises(ValueError):
        c.get(7).parent[0] = 5


def test_cache_capacity_zero_disables(pkg):
    c = pkg.ParentCache(0)
    c.put(1, np.zeros(V, np.int32), np.zeros(V, np.int32))
    assert len(c) == 0 and c.get(1) is None
    assert c.misses == 1 and c.evictions == 0
    with pytest.raises(ValueError):
        pkg.ParentCache(-1)


def test_policy_validation(pkg):
    for bad in (dict(batch_size=0), dict(max_wait_s=-1.0),
                dict(max_requeues=-1)):
        with pytest.raises(ValueError):
            pkg.CoalescePolicy(**bad)


def test_no_query_lost_or_duplicated_across_batch_boundaries(pkg):
    rng = np.random.default_rng(0)
    n = 200
    qs = [pkg.Query(i, int(r), float(t)) for i, (r, t) in enumerate(
        zip(rng.integers(0, 24, n), np.cumsum(rng.exponential(0.002, n))))]
    answers, batches = pkg.replay(qs, pkg.CoalescePolicy(batch_size=8,
                                                         max_wait_s=0.005),
                                  echo_solver(pkg), cache=pkg.ParentCache(16))
    assert sorted(a.qid for a in answers) == list(range(n))
    for a in answers:
        assert (a.parent == a.root).all()
        assert a.latency_s >= 0 and a.done_s >= a.arrival_s
    assert all(b.n_roots + b.n_pad == 8 for b in batches)
    assert [b.seq for b in batches] == list(range(len(batches)))


def test_padding_masked_from_accounting(pkg):
    solve = echo_solver(pkg)
    policy = pkg.CoalescePolicy(batch_size=4, max_wait_s=0.001)
    answers, batches = pkg.replay([pkg.Query(0, 5, 0.0)], policy, solve)
    assert len(answers) == 1 and answers[0].kind == "batch"
    b = batches[0]
    assert (b.n_roots, b.n_pad, b.occupancy) == (1, 3, 0.25)
    assert solve.calls[0][0] == (5, 5, 5, 5)

    def pad_fail(padded, n_real, fb):
        parent = np.tile(padded[:, None], (1, V)).astype(np.int32)
        return pkg.BatchOutcome(parent, parent, failed_rows={2, 3},
                                service_s=0.01)

    answers, batches = pkg.replay([pkg.Query(0, 5, 0.0)], policy, pad_fail)
    assert len(answers) == 1 and answers[0].kind == "batch"
    assert batches[0].failed_roots == []


def test_deadline_vs_size_launch(pkg):
    solve = echo_solver(pkg)
    qs = [pkg.Query(i, i, i * 1e-4) for i in range(4)]
    _, batches = pkg.replay(qs, pkg.CoalescePolicy(batch_size=4, max_wait_s=1.0),
                            solve)
    assert len(batches) == 1
    assert batches[0].t_launch == pytest.approx(3e-4)
    _, batches = pkg.replay([pkg.Query(0, 1, 0.5)],
                            pkg.CoalescePolicy(batch_size=4, max_wait_s=0.25), solve)
    assert batches[0].t_launch == pytest.approx(0.75)
    assert batches[0].oldest_wait_s == pytest.approx(0.25)


def test_same_root_coalesces_and_joins_in_flight(pkg):
    solve = echo_solver(pkg, service_s=1.0)
    qs = [pkg.Query(0, 7, 0.00), pkg.Query(1, 7, 0.01),
          pkg.Query(2, 7, 0.50), pkg.Query(3, 9, 0.60)]
    answers, batches = pkg.replay(qs, pkg.CoalescePolicy(batch_size=2,
                                                         max_wait_s=0.1), solve)
    by_qid = {a.qid: a for a in answers}
    assert by_qid[0].kind == "batch" and by_qid[1].kind == "batch"
    assert by_qid[2].kind == "join"
    assert by_qid[0].batch_seq == by_qid[2].batch_seq == 0
    assert by_qid[3].batch_seq == 1
    assert sum(p[:n].count(7) for p, n, _ in solve.calls) == 1
    assert batches[0].n_queries == 3


def test_cache_hit_after_completion_not_before(pkg):
    qs = [pkg.Query(0, 7, 0.0), pkg.Query(1, 7, 0.05), pkg.Query(2, 7, 0.50)]
    answers, _ = pkg.replay(qs, pkg.CoalescePolicy(batch_size=1, max_wait_s=0.01),
                            echo_solver(pkg, service_s=0.1),
                            cache=pkg.ParentCache(8))
    assert {a.qid: a.kind for a in answers} == {0: "batch", 1: "join", 2: "hit"}
    hit = next(a for a in answers if a.kind == "hit")
    assert hit.latency_s == 0.0 and (hit.parent == 7).all()


def test_requeued_roots_eventually_answered(pkg):
    solve = echo_solver(pkg, fail_roots={3}, fail_until_fallback=True)
    qs = [pkg.Query(0, 3, 0.0), pkg.Query(1, 5, 0.001)]
    answers, batches = pkg.replay(
        qs, pkg.CoalescePolicy(batch_size=2, max_wait_s=0.01, max_requeues=2),
        solve)
    by_qid = {a.qid: a for a in answers}
    assert by_qid[0].kind == "requeue" and by_qid[0].attempts == 1
    assert (by_qid[0].parent == 3).all()
    assert by_qid[1].kind == "batch"
    assert batches[0].failed_roots == [3]
    assert batches[0].check_counts == {"tree_edge": 1}
    assert not batches[0].used_fallback and batches[1].used_fallback
    assert by_qid[0].latency_s > by_qid[1].latency_s


def test_requeue_budget_exhausted_is_failed_not_wrong(pkg):
    solve = echo_solver(pkg, fail_roots={3})
    answers, _ = pkg.replay(
        [pkg.Query(0, 3, 0.0)],
        pkg.CoalescePolicy(batch_size=1, max_wait_s=0.0, max_requeues=1), solve)
    a = answers[0]
    assert len(answers) == 1
    assert a.kind == "failed" and a.parent is None and a.attempts == 2
    assert len(solve.calls) == 2


def test_burst_overflow_carries_into_full_batches(pkg):
    qs = [pkg.Query(i, i, i * 1e-6) for i in range(20)]
    _, batches = pkg.replay(qs, pkg.CoalescePolicy(batch_size=8, max_wait_s=0.01),
                            echo_solver(pkg))
    assert [b.n_roots for b in batches] == [8, 8, 4]


def test_report_summary_shapes(pkg):
    rng = np.random.default_rng(1)
    qs = [pkg.Query(i, int(r), float(t)) for i, (r, t) in enumerate(
        zip(rng.integers(0, 6, 50), np.cumsum(rng.exponential(0.02, 50))))]
    c = pkg.ParentCache(8)
    answers, batches = pkg.replay(qs, pkg.CoalescePolicy(batch_size=4,
                                                         max_wait_s=0.005),
                                  echo_solver(pkg), cache=c)
    s = pkg.ServeReport(answers, batches, c.stats()).summary()
    assert s["n_queries"] == 50 and sum(s["kinds"].values()) == 50
    assert (s["latency_p50_s"] <= s["latency_p99_s"]
            <= s["latency_p999_s"] <= s["latency_max_s"])
    assert s["qps"] > 0 and np.isfinite(s["qps"])
    assert sum(s["occupancy_hist"]) == s["n_batches"] == len(batches)
    assert len(s["occupancy_hist"]) == 4 + 1
    assert 0.0 < s["occupancy_mean"] <= 1.0
    assert s["cache"]["hits"] == c.hits > 0


def test_synth_trace_deterministic_and_zipf_shaped(pkg):
    t1 = pkg.synth_trace(5, 400, 1000, rate_qps=100.0, zipf_s=1.3)
    t2 = pkg.synth_trace(5, 400, 1000, rate_qps=100.0, zipf_s=1.3)
    assert np.array_equal(t1.roots, t2.roots)
    assert np.array_equal(t1.arrival_s, t2.arrival_s)
    assert (np.diff(t1.arrival_s) >= 0).all()
    assert np.sum(t1.roots < 10) > np.sum(t1.roots >= 500)
    deg = np.zeros(1000)
    deg[[3, 4, 5]] = 1
    assert set(pkg.synth_trace(5, 50, 1000, degree=deg).roots.tolist()) <= {3, 4, 5}
    qs = t1.queries()
    assert len(qs) == 400 and qs[0].qid == 0
    with pytest.raises(ValueError, match="n_queries"):
        pkg.synth_trace(1, 0, 10)
    with pytest.raises(ValueError, match="rate_qps"):
        pkg.synth_trace(1, 5, 10, rate_qps=0.0)


# ---------------------------------------------------------------------------
# The copies equal the JAX package's, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,rate,zipf,with_degree", [
    (7, 64, 2.0, 1.4, True), (7, 64, 2000.0, 1.1, True),
    (5, 400, 100.0, 1.3, False), (2**33 + 1, 50, 0.5, 0.8, True)])
def test_synth_trace_bit_identical_to_jax(seed, n, rate, zipf, with_degree):
    rng = np.random.default_rng(3)
    degree = (rng.integers(0, 3, 500) * rng.integers(0, 2, 500)).astype(np.int32)
    kw = dict(rate_qps=rate, zipf_s=zipf, start_s=0.25)
    want = jtrace.synth_trace(seed, n, 500, degree=degree if with_degree else None,
                              **kw)
    got = query_trace.synth_trace(
        seed, n, 500, degree=torch.from_numpy(degree) if with_degree else None, **kw)
    assert got.roots.dtype == want.roots.dtype
    np.testing.assert_array_equal(got.roots, want.roots)
    np.testing.assert_array_equal(got.arrival_s, want.arrival_s)
    assert (got.seed, got.rate_qps, got.zipf_s, got.n_vertices) == \
        (want.seed, want.rate_qps, want.zipf_s, want.n_vertices)
    assert [dataclasses.astuple(q) for q in got.queries()] == \
        [dataclasses.astuple(q) for q in want.queries()]


# ---------------------------------------------------------------------------
# Engines on one device: the port's against the JAX package's
# ---------------------------------------------------------------------------

_GRAPHS: dict = {}


def graphs(name):
    """(JAX prepared graph, port built graph), cached: ``scale10`` is the
    pipeline's scale-10 graph (``tests/test_serve.py:305``), ``scale9`` the
    serve_batch graph (seed 3, core threshold 8), ``sssp`` a weighted
    scale-9 graph."""
    if name not in _GRAPHS:
        if name == "scale10":
            jb = jpipe.build(jpipe.Graph500Config(scale=10, batched=True))
            ev, degree, core = jb.ev, jb.degree, jb.core
        else:
            edges = jax_generate_edges(3 if name == "scale9" else 11, 9)
            g0 = jax_build_csr(edges)
            g = jax_build_csr(jax_relabel_edges(edges, jax_degree_reorder(g0.degree)))
            ev, degree = jax_edge_view(g), g.degree
            core = jax_build_heavy_core(g, threshold=8) if name == "scale9" else None
            if name == "sssp":
                ev = jax_with_edge_weights(ev, seed=1)
        jp = JaxPrepared(ev=ev, degree=degree, core=core,
                         chunks=jax_chunk_edge_view(ev))
        tb = convert.built_from_numpy(
            np.asarray(ev.src), np.asarray(ev.dst), np.asarray(ev.valid),
            np.asarray(degree), num_vertices=ev.num_vertices,
            a_core=None if core is None else np.asarray(core.a_core),
            k_heavy=None if core is None else int(core.k_heavy),
            threshold=100 if core is None else core.threshold,
            weight=None if ev.weight is None else np.asarray(ev.weight),
            device="cpu")
        _GRAPHS[name] = (jp, tb)
    return _GRAPHS[name]


def fixed_clock(eng, service_s=0.02):
    """Replace the engine's measured service time by a constant, so two
    engines replay one trace on one virtual clock."""
    solve = eng.solve_batch

    def solve_fixed(padded, n_real, use_fallback):
        out = solve(padded, n_real, use_fallback)
        out.service_s = service_s
        return out

    eng.solve_batch = solve_fixed
    return eng


def assert_reports_equal(got, want):
    assert len(got.answers) == len(want.answers)
    for a, b in zip(got.answers, want.answers):
        assert (a.qid, a.root, a.kind, a.attempts, a.batch_seq) == \
            (b.qid, b.root, b.kind, b.attempts, b.batch_seq)
        assert (a.arrival_s, a.done_s, a.latency_s) == \
            (b.arrival_s, b.done_s, b.latency_s)
        if b.parent is None:
            assert a.parent is None and a.level is None
        else:
            np.testing.assert_array_equal(a.parent, np.asarray(b.parent))
            np.testing.assert_array_equal(a.level, np.asarray(b.level))
    assert [dataclasses.asdict(x) for x in got.batches] == \
        [dataclasses.asdict(y) for y in want.batches]
    assert got.cache_stats == want.cache_stats
    assert got.summary() == want.summary()


def assert_answers_offline(report, compiled, failed_root=None):
    """Every answer equals the offline run of its root; only
    ``failed_root`` may come back failed, and then every time."""
    uniq = sorted({a.root for a in report.answers if a.root != failed_root})
    res = compiled.run(np.asarray(uniq, np.int32), warmup=False, check="off")
    idx = {r: i for i, r in enumerate(uniq)}
    for a in report.answers:
        if a.root == failed_root:
            assert a.kind == "failed" and a.parent is None
            continue
        assert a.kind != "failed"
        np.testing.assert_array_equal(a.parent, res.parent[idx[a.root]])
        np.testing.assert_array_equal(a.level, res.level[idx[a.root]])


@pytest.mark.parametrize("clock", ["fixed", "measured"])
def test_engine_serve_equal_to_jax_and_offline(clock):
    jp, tb = graphs("scale10")
    scfg = dict(batch_size=4, max_wait_s=0.01, cache_capacity=32)
    cfg = pipeline.Graph500Config(scale=10, batched=True, device="cpu")
    built, eng = pipeline.serve(cfg, serve_cfg=engine.ServeConfig(**scfg), built=tb)
    assert built is tb and eng.plan.batch_roots and eng.compiled.device.type == "cpu"
    trace = query_trace.synth_trace(7, 32, tb.n_vertices, rate_qps=2.0, zipf_s=1.4,
                                    degree=tb.degree)
    if clock == "fixed":
        jeng = jengine.Engine(jp, plan=JaxPlan(layout=(), batch_roots=True),
                              config=jengine.ServeConfig(**scfg))
        want = fixed_clock(jeng).serve(jtrace.synth_trace(
            7, 32, tb.n_vertices, rate_qps=2.0, zipf_s=1.4,
            degree=np.asarray(jp.degree)))
        got = fixed_clock(eng).serve(trace)
        assert_reports_equal(got, want)
    else:
        got = eng.serve(trace)
    assert len(got.answers) == 32
    s = got.summary()
    assert s["cache"]["hits"] > 0
    assert all(v == 0 for v in s["check_counts"].values())
    assert_answers_offline(got, eng.compiled)
    assert eng.batches_served == len(got.batches)


def test_serve_batch_primitive_equal_to_jax_and_run():
    jp, tb = graphs("scale9")
    jc = jax_compile(JaxPlan(layout=(), batch_roots=True), jp)
    tc = compile_plan(BFSPlan(layout=(), batch_roots=True), tb, device="cpu")
    roots = np.asarray([1, 5, 1, 9], np.int32)
    sb = tc.serve_batch(roots, check="post")
    want = jc.serve_batch(roots, check="post")
    res = tc.run(roots, warmup=False, check="post")
    np.testing.assert_array_equal(sb.parent, np.asarray(want.parent))
    np.testing.assert_array_equal(sb.level, np.asarray(want.level))
    assert sb.counts == want.counts and sb.failures == want.failures == {}
    assert np.array_equal(sb.parent, res.parent)
    assert np.array_equal(sb.level, res.level)
    assert isinstance(sb.parent, np.ndarray) and sb.parent.dtype == np.int32
    empty = tc.serve_batch(np.zeros(0, np.int32))
    assert empty.parent.shape == (0, tb.n_vertices) and empty.failures == {}
    with pytest.raises(ValueError):
        tc.serve_batch(roots, check="bogus")


@pytest.mark.parametrize("overrides", [
    None, {"alpha": 7.0, "batch_roots": False}, {"beta": 30.0, "n_chunks": 8}])
def test_resolve_serve_plan_equal_to_jax(overrides):
    p = engine.resolve_serve_plan(overrides=overrides)
    want = jengine.resolve_serve_plan(overrides=overrides)
    assert p.to_dict() == want.to_dict()
    assert p.batch_roots and p.engine == "bitmap" and p.layout == ()
    assert BFSPlan(**p.to_dict()) == p


def test_resolve_serve_plan_with_scale_waits_for_tuning(monkeypatch, tmp_path):
    # tuning is ported: a scale with no table entry serves the untuned
    # plan, as JAX's does; one with an entry serves it, batched
    # (tests/test_torch_tune.py holds the table against JAX's)
    monkeypatch.setenv("REPRO_TORCH_TUNED_PLANS", str(tmp_path / "missing.json"))
    monkeypatch.setenv("REPRO_TUNED_PLANS", str(tmp_path / "missing.json"))
    want = jengine.resolve_serve_plan(12).to_dict()
    assert engine.resolve_serve_plan(12, device="cpu").to_dict() == want
    _, tb = graphs("scale9")
    cfg = engine.ServeConfig(warmup=False)
    assert engine.Engine(tb, scale=12, device="cpu", config=cfg).plan.to_dict() == want
    from repro_torch.core import tune
    tuned = BFSPlan(batch_roots=False, alpha=8.0, n_chunks=16)
    tune.save_tuned(tune.TuneReport(
        12, 1, "cpu", True, "small", 1, 2, 1,
        results=[tune.TuneResult(tuned, "ok", per_root_us=1.0, identical=True)]),
        str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNED_PLANS", str(tmp_path / "t.json"))
    eng = engine.Engine(tb, scale=12, device="cpu", config=cfg)
    assert eng.plan == dataclasses.replace(tuned, batch_roots=True)


def test_faulted_engine_fails_that_root_only_like_jax():
    # a persistent parent fault on the hottest root: every query for it
    # comes back failed after max_requeues, never as a wrong tree
    jp, tb = graphs("scale10")
    trace = query_trace.synth_trace(11, 24, tb.n_vertices, rate_qps=20.0,
                                    zipf_s=1.3, degree=tb.degree)
    roots, n = np.unique(trace.roots, return_counts=True)
    hot = int(roots[np.argmax(n)])
    fkw = dict(site="parent", kind="self", level=1, persistent=True, root=hot)
    scfg = dict(batch_size=4, max_wait_s=0.01, cache_capacity=32, max_requeues=2,
                check="full")
    eng = fixed_clock(engine.Engine(tb, config=engine.ServeConfig(**scfg),
                                    fault=faults.FaultSpec(**fkw), device="cpu"))
    jeng = fixed_clock(jengine.Engine(jp, config=jengine.ServeConfig(**scfg),
                                      fault=jfaults.FaultSpec(**fkw)))
    got = eng.serve(trace)
    assert_reports_equal(got, jeng.serve(trace))
    failed = [a for a in got.answers if a.kind == "failed"]
    assert len(failed) == int(n.max()) and all(a.attempts == 3 for a in failed)
    assert any(b.failed_roots == [hot] for b in got.batches)
    assert any(b.used_fallback for b in got.batches)
    assert hot not in eng.cache
    clean = compile_plan(BFSPlan(layout=(), batch_roots=True), tb, device="cpu")
    assert_answers_offline(got, clean, failed_root=hot)


def test_sssp_engine_equal_to_jax_and_offline():
    jp, tb = graphs("sssp")
    scfg = dict(batch_size=4, max_wait_s=0.01, cache_capacity=8)
    trace = query_trace.synth_trace(3, 16, tb.n_vertices, rate_qps=5.0,
                                    zipf_s=1.2, degree=tb.degree)
    eng = fixed_clock(engine.Engine(tb, config=engine.ServeConfig(**scfg),
                                    kernel="sssp", device="cpu"))
    jeng = fixed_clock(jengine.Engine(jp, config=jengine.ServeConfig(**scfg),
                                      kernel="sssp"))
    assert eng.plan.kernel == "sssp" and eng.plan.exchange == "hier_min"
    assert eng.plan.to_dict() == jeng.plan.to_dict()
    got = eng.serve(trace)
    assert_reports_equal(got, jeng.serve(trace))
    assert len(got.answers) == 16
    assert all(v == 0 for v in got.summary()["check_counts"].values())
    assert_answers_offline(got, eng.compiled)
