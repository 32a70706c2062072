"""The port's bitmap BFS engine, validation and pipeline against the JAX
package, bit for bit.

Both packages traverse the same graph from the same roots: the JAX-built
graph is carried into the port with ``repro_torch.convert``.  Parents,
levels and every ``BFSStats`` trace must be identical, per root and
batched, at scales 10 and 12 and at V = 2^15 (where the padding sentinel's
bitmap word is one past the end).
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import kronecker as jkron
from repro.core import pipeline as jpipe
from repro.core.hybrid_bfs import BFSResult as JaxBFSResult
from repro.core.hybrid_bfs import _switch_direction as jax_switch
from repro.core.plan import BFSPlan as JaxPlan
from repro.core.plan import compile_plan as jax_compile
from repro.core.teps import batch_harmonic_mean_teps as jax_batch_hmean
from repro.core.validate import validate as jax_validate
from repro.core.validate import validate_batch as jax_validate_batch
from repro_torch import convert
from repro_torch.core import hybrid_bfs, pipeline
from repro_torch.core.heavy import padded_bitmap_words
from repro_torch.core.hybrid_bfs import BFSResult, _switch_direction
from repro_torch.core.plan import BFSPlan, compile_plan
from repro_torch.core.teps import batch_harmonic_mean_teps
from repro_torch.core.validate import failure_report, validate, validate_batch
from repro_torch.serve.engine import resolve_serve_plan

from core_spmv_cases import core_steps

torch.set_num_threads(2)

_GRAPHS: dict = {}


def graphs(scale, edge_factor=16, n_roots=3):
    """(JAX built graph, port built graph, relabeled roots), cached."""
    key = (scale, edge_factor, n_roots)
    if key not in _GRAPHS:
        cfg = jpipe.Graph500Config(scale=scale, edge_factor=edge_factor)
        jb = jpipe.build(cfg)
        edges = jkron.generate_edges(cfg.seed, scale, edge_factor)
        roots = np.asarray(jb.reorder.new_from_old[
            jkron.sample_roots(cfg.seed, edges, n_roots)])
        tb = convert.built_from_numpy(
            np.asarray(jb.ev.src), np.asarray(jb.ev.dst), np.asarray(jb.ev.valid),
            np.asarray(jb.degree), num_vertices=jb.n_vertices,
            a_core=np.asarray(jb.core.a_core), k_heavy=int(jb.core.k_heavy),
            threshold=jb.core.threshold, device="cpu")
        _GRAPHS[key] = (jb, tb, roots)
    return _GRAPHS[key]


def assert_results_equal(got, want):
    np.testing.assert_array_equal(got.parent.numpy(), np.asarray(want.parent))
    np.testing.assert_array_equal(got.level.numpy(), np.asarray(want.level))
    for f in want.stats._fields:
        np.testing.assert_array_equal(getattr(got.stats, f).numpy(),
                                      np.asarray(getattr(want.stats, f)), err_msg=f)


@pytest.mark.parametrize("scale,edge_factor", [(10, 16), (12, 16), (15, 1)])
@pytest.mark.parametrize("batch", [False, True])
def test_bitmap_engine_bitwise_equal_to_jax(scale, edge_factor, batch):
    jb, tb, roots = graphs(scale, edge_factor)
    if scale == 15:
        # the sentinel-word case: padding edges read word V // 32 == W
        assert jb.n_vertices // 32 == padded_bitmap_words(jb.n_vertices)
    jc = jax_compile(JaxPlan(engine="bitmap", layout=(), batch_roots=batch), jb)
    tc = compile_plan(BFSPlan(engine="bitmap", layout=(), batch_roots=batch), tb,
                      device="cpu")
    if batch:
        assert_results_equal(tc.bfs(roots), jc.bfs(roots))
    else:
        for r in roots:
            assert_results_equal(tc.bfs(int(r)), jc.bfs(int(r)))
    got = tc.bfs(roots if batch else int(roots[0]))
    assert (got.stats.direction == hybrid_bfs.BOTTOM_UP).any()


@pytest.mark.parametrize("rung", ["pre-g500", "pre-g500-batch", "no-core"])
def test_bitmap_rungs_bitwise_equal_to_jax(rung):
    # the rungs' relax through the plain bfs_relax: parent, level and every
    # stats field of every key equal the JAX engine's scatter-min, with the
    # heavy core and without one (every row walked whole)
    kw = dict(scale=11, n_roots=4)
    jcfg = (jpipe.Graph500Config(engine="bitmap", heavy_threshold=None, **kw)
            if rung == "no-core" else jpipe.Graph500Config.ladder(rung, **kw))
    jbuilt = jpipe.build(jcfg)
    edges = jkron.generate_edges(jcfg.seed, jcfg.scale, jcfg.edge_factor)
    roots = np.asarray(jkron.sample_roots(jcfg.seed, edges, jcfg.n_roots))
    cfg = (pipeline.Graph500Config(engine="bitmap", heavy_threshold=None, device="cpu", **kw)
           if rung == "no-core" else pipeline.Graph500Config.ladder(rung, device="cpu", **kw))
    built = pipeline.build(cfg, edges=convert.edge_list_from_numpy(
        np.asarray(edges.src), np.asarray(edges.dst), edges.num_vertices, "cpu"))
    assert (built.core is None) == (jbuilt.core is None) == (rung == "no-core")
    keys = pipeline.search_keys(cfg, built, roots)
    np.testing.assert_array_equal(keys, np.asarray(jbuilt.reorder.new_from_old[roots]))
    tc = compile_plan(cfg.to_plan(), built, device="cpu")
    jc = jax_compile(jcfg.to_plan(), jbuilt)
    batch = cfg.to_plan().batch_roots
    assert batch == (rung == "pre-g500-batch")
    outs = ([(tc.bfs(keys), jc.bfs(keys))] if batch
            else [(tc.bfs(int(k)), jc.bfs(int(k))) for k in keys])
    for got, want in outs:
        assert_results_equal(got, want)
        assert (got.stats.direction == hybrid_bfs.BOTTOM_UP).any()


@pytest.mark.parametrize("scale", [13, 14])
def test_core_step_skipped_once_every_core_row_is_visited(monkeypatch, scale):
    # K = 4,096 < V here, so the core's rows (the heaviest vertices) are all
    # visited within a few levels: a bottom-up level that begins with none
    # of them unvisited issues neither core_spmv nor the merge, and parents,
    # levels and every stats field still equal the JAX engine's (which runs
    # every core step) and parents and levels the port's reference engine's
    kw = dict(scale=scale, n_roots=6)
    jcfg = jpipe.Graph500Config.ladder("pre-g500", **kw)
    jbuilt = jpipe.build(jcfg)
    edges = jkron.generate_edges(jcfg.seed, jcfg.scale, jcfg.edge_factor)
    roots = np.asarray(jkron.sample_roots(jcfg.seed, edges, jcfg.n_roots))
    cfg = pipeline.Graph500Config.ladder("pre-g500", device="cpu", **kw)
    built = pipeline.build(cfg, edges=convert.edge_list_from_numpy(
        np.asarray(edges.src), np.asarray(edges.dst), edges.num_vertices, "cpu"))
    core_rows = min(built.core.k, built.n_vertices)
    assert core_rows < built.n_vertices
    keys = pipeline.search_keys(cfg, built, roots)
    tc = compile_plan(cfg.to_plan(), built, device="cpu")
    tref = compile_plan(dataclasses.replace(cfg.to_plan(), engine="reference"), built,
                        device="cpu")
    jc = jax_compile(jcfg.to_plan(), jbuilt)
    launches = []
    real = hybrid_bfs.kops.core_spmv

    def spy(*a, **k):
        launches.append(1)
        return real(*a, **k)

    monkeypatch.setattr(hybrid_bfs.kops, "core_spmv", spy)
    n_bu = skipped = 0
    for k in keys:
        launches.clear()
        got = tc.bfs(int(k))
        assert_results_equal(got, jc.bfs(int(k)))
        want = tref.bfs(int(k))
        assert torch.equal(got.parent, want.parent) and torch.equal(got.level, want.level)
        bu, launched = core_steps(got, core_rows)
        assert len(launches) == launched
        n_bu, skipped = n_bu + bu, skipped + bu - launched
    assert 0 < skipped < n_bu


@pytest.mark.parametrize("scale", [10, 12])
def test_engine_alternates_two_output_pairs(monkeypatch, scale):
    # every level's epilogue writes into caller buffers: two (frontier,
    # visited) pairs taken in turn and one count, none aliasing the level's
    # inputs; parents, levels and stats stay bitwise equal to the JAX engine
    jb, tb, roots = graphs(scale)
    calls = []
    real = hybrid_bfs.kops.frontier_update

    def recording(next_raw, visited, out=None):
        assert out is not None
        calls.append((visited.data_ptr(), tuple(t.data_ptr() for t in out)))
        return real(next_raw, visited, out=out)

    monkeypatch.setattr(hybrid_bfs.kops, "frontier_update", recording)
    jc = jax_compile(JaxPlan(engine="bitmap", layout=(), batch_roots=False), jb)
    tc = compile_plan(BFSPlan(engine="bitmap", layout=(), batch_roots=False), tb,
                      device="cpu")
    got = tc.bfs(int(roots[0]))
    assert_results_equal(got, jc.bfs(int(roots[0])))
    n_levels = int(got.stats.levels)
    assert len(calls) == n_levels >= 3
    pairs = [out[:2] for _, out in calls]
    assert len(set(pairs)) == 2 and pairs[0] != pairs[1]
    assert all(pairs[i] == pairs[i % 2] for i in range(n_levels))
    assert len({out[2] for _, out in calls}) == 1
    # each level reads the visited bitmap the level before wrote
    assert all(calls[i][0] == calls[i - 1][1][1] for i in range(1, n_levels))
    assert all(calls[i][0] not in calls[i][1] for i in range(n_levels))


@pytest.mark.parametrize("rung", ["pre-g500", "pre-g500-batch", "no-core", "parent-fault"])
def test_visited_bitmap_holds_exactly_the_vertices_with_a_parent(monkeypatch, rung):
    # the level's delta tests the visited bitmap where the engine once took a
    # snapshot of parent_ext == V: at the start of every level (where its
    # first parent write happens: the top-down relax, the core merge, or the
    # bottom-up relax of a rung without a core) and after every level's
    # frontier_update, visited_bm == pack_bitmap(parent_ext[:V] != V); under
    # a persistent parent fault too, whose wrong parents are never V
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.heavy import pack_bitmap
    kw = dict(scale=11, n_roots=3, device="cpu")
    cfg = (pipeline.Graph500Config(engine="bitmap", heavy_threshold=None, **kw)
           if rung == "no-core"
           else pipeline.Graph500Config.ladder("pre-g500-batch" if rung == "pre-g500-batch"
                                               else "pre-g500", **kw))
    built = pipeline.build(cfg)
    keys = [int(k) for k in pipeline.search_keys(cfg, built)]
    fault = (FaultSpec("parent", "offset", level=1, persistent=True)
             if rung == "parent-fault" else None)
    tc = compile_plan(cfg.to_plan(), built, device="cpu", fault=fault)
    kops = hybrid_bfs.kops
    state = dict(fresh=True, starts=0, ends=0, parent=None, visited=None)

    def holds(visited_bm, parent_ext):
        v = parent_ext.shape[0] - 1
        return torch.equal(visited_bm, pack_bitmap(parent_ext[:v] != v, visited_bm.shape[0]))

    def first_write(name, visited_of, parent_of):
        real = getattr(kops, name)

        def spy(*args):
            if state["fresh"]:
                assert holds(visited_of(args), parent_of(args)), name
                state["fresh"], state["starts"] = False, state["starts"] + 1
            return real(*args)
        monkeypatch.setattr(kops, name, spy)

    first_write("bfs_relax_top_down", lambda a: a[1], lambda a: a[5])
    first_write("bfs_core_merge", lambda a: a[1], lambda a: a[2])
    first_write("bfs_relax_bottom_up", lambda a: state["visited"], lambda a: a[1])
    real_delta, real_update = kops.bfs_level_delta, kops.frontier_update

    def delta(parent_ext, *args):
        state["parent"] = parent_ext
        return real_delta(parent_ext, *args)

    def update(found, visited_bm, out):
        real_update(found, visited_bm, out=out)
        assert holds(out[1], state["parent"])
        state.update(fresh=True, visited=out[1], ends=state["ends"] + 1)
        return out

    monkeypatch.setattr(kops, "bfs_level_delta", delta)
    monkeypatch.setattr(kops, "frontier_update", update)
    results = [tc.bfs(keys)] if cfg.to_plan().batch_roots else [tc.bfs(k) for k in keys]
    levels = sum(int(r.stats.levels.sum()) for r in results)
    assert state["starts"] == state["ends"] == levels > 3 * len(keys)
    directions = torch.cat([r.stats.direction.reshape(-1) for r in results])
    assert bool((directions == hybrid_bfs.BOTTOM_UP).any())
    sentinels = torch.cat([r.stats.sentinel.reshape(-1) for r in results])
    assert bool((sentinels[sentinels >= 0] == hybrid_bfs.SENTINEL_OK).all())


def _f32_edge(divisor: float):
    """An x where float32 division truncates differently from float64."""
    for x in range(2**24, 2**24 + 200_000):
        if int(np.float32(x) / np.float32(divisor)) != int(x / divisor):
            return x
    raise AssertionError("no float32 rounding edge found")


@pytest.mark.parametrize("which", ["thrv1", "thrv2"])
def test_switch_direction_float32_edge(which):
    alpha, beta = 14.0, 24.0
    if which == "thrv1":
        vis = 1000
        x = _f32_edge(alpha)
        n_active, direction = x + vis, hybrid_bfs.TOP_DOWN
        thr32, thr64 = int(np.float32(x) / np.float32(alpha)), int(x / alpha)
    else:
        vis = 5
        x = _f32_edge(beta)
        n_active, direction = x, hybrid_bfs.BOTTOM_UP
        thr32, thr64 = int(np.float32(x) / np.float32(beta)), int(x / beta)
    assert thr32 != thr64
    flips = set()
    for in_count in range(min(thr32, thr64) - 1, max(thr32, thr64) + 2):
        got = _switch_direction(direction, in_count, vis, n_active, alpha, beta)
        want = int(jax_switch(jnp.int32(direction), jnp.int32(in_count),
                              jnp.int32(vis), jnp.int32(n_active), alpha, beta))
        assert got == want, (in_count, got, want)
        flips.add(got)
    assert flips == {0, 1}


def _corruptions(jb, root, parent, level):
    """(name, parent, level) rows: clean plus deliberately broken trees."""
    v = jb.n_vertices
    deg = np.asarray(jb.degree)
    visited = np.nonzero((parent >= 0) & (np.arange(v) != root))[0]
    deep = visited[np.argmax(level[visited])]
    rows = [("clean", parent, level)]

    def mut(name, *changes):
        p, l = parent.copy(), level.copy()
        for arr, idx, val in changes:
            (p if arr == "p" else l)[idx] = val
        rows.append((name, p, l))

    mut("root_parent", ("p", root, deep))
    mut("root_level", ("l", root, 1))
    mut("level_plus_one", ("l", deep, level[deep] + 1))
    non_nbr = int(np.nonzero((level == level[deep] - 1))[0][-1])
    src, dst = np.asarray(jb.ev.src), np.asarray(jb.ev.dst)
    if non_nbr in set(dst[src == deep].tolist()):
        non_nbr = root
    mut("non_edge_parent", ("p", deep, non_nbr))
    mut("dropped_vertex", ("p", deep, -1), ("l", deep, -1))
    mut("parent_out_of_range", ("p", deep, v + 5))
    mut("self_parent", ("p", deep, deep))
    isolated = np.nonzero(deg == 0)[0]
    if len(isolated):
        # a vertex with no edge entries: JAX's empty segment_max counts it
        # as witnessed, the port must agree
        mut("isolated_adopted", ("p", int(isolated[0]), root),
            ("l", int(isolated[0]), 1))
    return rows


def test_validate_checks_match_jax_on_clean_and_corrupted():
    jb, tb, roots = graphs(10)
    jc = jax_compile(JaxPlan(engine="bitmap", layout=(), batch_roots=True), jb)
    res = jc.bfs(roots)
    root = int(roots[0])
    rows = _corruptions(jb, root, np.array(res.parent[0]), np.array(res.level[0]))
    assert len(rows) >= 8
    for name, p, l in rows:
        want = jax_validate(jb.ev, JaxBFSResult(jnp.asarray(p), jnp.asarray(l), None),
                            jnp.int32(root))
        got = validate(tb.ev, BFSResult(torch.from_numpy(p), torch.from_numpy(l), None),
                       root)
        assert [bool(x) for x in got] == [bool(x) for x in want], name
        assert bool(got.ok) == (name in ("clean", "isolated_adopted")), name
    ps = np.stack([p for _, p, _ in rows])
    ls = np.stack([l for _, _, l in rows])
    rs = np.full(len(rows), root, np.int32)
    got_b = validate_batch(tb.ev, torch.from_numpy(ps), torch.from_numpy(ls), rs)
    want_b = jax_validate_batch(jb.ev, jnp.asarray(ps), jnp.asarray(ls), rs)
    from repro.core.validate import failure_report as jax_failure_report
    assert failure_report(got_b) == jax_failure_report(want_b)


@pytest.mark.parametrize("check", ["off", "post", "full"])
@pytest.mark.parametrize("batch", [False, True])
def test_compiled_run_matches_jax(check, batch):
    jb, tb, roots = graphs(10)
    jr = jax_compile(JaxPlan(engine="bitmap", layout=(), batch_roots=batch),
                     jb).run(roots, check=check)
    tr = compile_plan(BFSPlan(batch_roots=batch), tb, device="cpu").run(
        roots, check=check)
    np.testing.assert_array_equal(tr.parent, np.asarray(jr.parent))
    np.testing.assert_array_equal(tr.level, np.asarray(jr.level))
    assert tr.run.edges == jr.run.edges
    assert tr.run.check_counts == jr.run.check_counts
    assert tr.run.validated == jr.run.validated
    assert tr.run.all_valid == jr.run.all_valid == (check != "off")
    assert tr.run.batched == batch and len(tr.run.teps) == len(roots)


@pytest.mark.parametrize("kw", [
    dict(),                                       # the pre-g500 rung
    dict(batched=True),                           # pre-g500-batch
    dict(degree_sort=False, heavy_threshold=None),  # no sort, no core
])
def test_pipeline_run_matches_jax(kw):
    jcfg = jpipe.Graph500Config(scale=10, n_roots=3, engine="bitmap", **kw)
    jbuilt, jrun = jpipe.run(jcfg)
    edges = jkron.generate_edges(jcfg.seed, jcfg.scale, jcfg.edge_factor)
    roots = np.asarray(jkron.sample_roots(jcfg.seed, edges, jcfg.n_roots))
    cfg = pipeline.Graph500Config(scale=10, n_roots=3, device="cpu", **kw)
    built = pipeline.build(cfg, edges=convert.edge_list_from_numpy(
        np.asarray(edges.src), np.asarray(edges.dst), edges.num_vertices, "cpu"))
    built, run = pipeline.run(cfg, built, roots=roots)
    assert (built.core is None) == (jbuilt.core is None)
    assert run.edges == jrun.edges
    assert run.all_valid and jrun.all_valid
    assert run.check_counts == jrun.check_counts
    keys = pipeline.search_keys(cfg, built, roots)
    jkeys = (roots if jbuilt.reorder is None
             else np.asarray(jbuilt.reorder.new_from_old[roots]))
    np.testing.assert_array_equal(keys, jkeys)
    tres = compile_plan(cfg.to_plan(), built, device="cpu").run(keys)
    jres = jax_compile(jcfg.to_plan(), jbuilt).run(keys)
    np.testing.assert_array_equal(tres.parent, np.asarray(jres.parent))
    np.testing.assert_array_equal(tres.level, np.asarray(jres.level))
    # the fused-batch TEPS helper at a uniform per-root time
    assert batch_harmonic_mean_teps(built.degree, torch.from_numpy(tres.parent),
                                    1e-3) == pytest.approx(
        jax_batch_hmean(jbuilt.degree, jnp.asarray(jres.parent), 1e-3), rel=1e-12)


def test_plan_dict_round_trip_matches_jax():
    for kw in ({}, dict(batch_roots=False, alpha=8.0, n_chunks=16)):
        p, jp = BFSPlan(**kw), JaxPlan(**kw)
        assert p.to_dict() == jp.to_dict()
        assert BFSPlan.from_dict(jp.to_dict()) == p
    with pytest.raises(ValueError, match="unknown BFSPlan fields"):
        BFSPlan.from_dict({"engine": "bitmap", "warp_size": 32})


@pytest.mark.parametrize("kw,err", [
    # the legacy engines run per root: with the default batch_roots=True
    # the plan is refused, as in JAX
    (dict(engine="legacy"), ValueError),
    (dict(engine="reference"), ValueError),
    # mesh layouts are ported: too few devices and a non-pow2 member axis
    # are JAX's ValueErrors
    (dict(layout=("root",), mesh_shape=(4,)), ValueError),
    (dict(layout=("group", "member"), mesh_shape=(2, 3)), ValueError),
    # SSSP on a graph without a weight plane, as in JAX
    (dict(kernel="sssp"), ValueError),
    (dict(engine="warp"), ValueError),
    (dict(layout=("rows",)), ValueError),
    (dict(exchange="smoke"), ValueError),
    (dict(n_chunks=0), ValueError),
])
def test_unported_plans_raise(kw, err):
    _, tb, _ = graphs(10)
    with pytest.raises(err):
        compile_plan(BFSPlan(**kw), tb, device="cpu")


def test_unported_run_options_raise(monkeypatch, tmp_path):
    _, tb, roots = graphs(10)
    c = compile_plan(BFSPlan(), tb, device="cpu")
    # checked execution is ported (tests/test_torch_faults.py): recovery
    # armed on a clean plan finds nothing to do
    run = c.run(roots, retries=1, fallback=True).run
    assert run.all_valid and (run.retries, run.fallbacks, run.quarantined) == (0, 0, [])
    with pytest.raises(ValueError, match="check must be"):
        c.run(roots, check="half")
    # the 1-shard root mesh of one device is the single-device batch
    mesh1 = compile_plan(BFSPlan(layout=("root",)), tb, device="cpu")
    assert mesh1.mesh_axes == {"root": 1}
    assert_results_equal(mesh1.bfs(roots), jax_compile(JaxPlan(), graphs(10)[0]).bfs(roots))
    # a plan needing more devices than there are is JAX's ValueError
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        compile_plan(BFSPlan(layout=("root",), mesh_shape=(4,)), tb, device="cpu")
    # tuning is ported (tests/test_torch_tune.py): with no table entry the
    # tuned serving plan and the tuned rung are the untuned batched plan
    monkeypatch.setenv("REPRO_TORCH_TUNED_PLANS", str(tmp_path / "missing.json"))
    assert resolve_serve_plan(10, device="cpu") == resolve_serve_plan()
    tuned = pipeline.Graph500Config.ladder("pre-g500-tuned", device="cpu")
    assert tuned.to_plan() == pipeline.Graph500Config.ladder(
        "pre-g500-batch").to_plan()
    # the mesh rungs are ported: they lower to JAX's plans
    for rung in ("pre-g500-mesh", "pre-g500-mesh3"):
        assert pipeline.Graph500Config.ladder(rung).to_plan().to_dict() == \
            jpipe.Graph500Config.ladder(rung).to_plan().to_dict()
    # the legacy and TH-2 rungs are ported: they lower to per-root plans of
    # their engines, as in JAX
    for rung, engine in (("pre-g500-legacy", "legacy"), ("th2", "reference")):
        plan = pipeline.Graph500Config.ladder(rung).to_plan()
        assert (plan.engine, plan.batch_roots) == (engine, False)
        assert plan.to_dict() == jpipe.Graph500Config.ladder(rung).to_plan().to_dict()
