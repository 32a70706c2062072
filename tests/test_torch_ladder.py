"""The port's reference and legacy engines (the Fig. 18 ladder's lower
rungs) against the JAX package, bit for bit.

Both packages traverse the same JAX-built graph from the same roots (the
graph carried into the port with ``repro_torch.convert``).  Parents,
levels and every ``BFSStats`` field must be identical, at scale 8 (where
the padded core, K = 4096, exceeds V = 256), 10, 12 and at V = 2^15 with
edge factor 1; the JAX legacy engine runs its Pallas ``core_spmv`` in
interpret mode, the port its plain version.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import kronecker as jkron
from repro.core import pipeline as jpipe
from repro.core.bfs_steps import frontier_edge_count as jax_frontier_edge_count
from repro.core.bfs_steps import masked_relax_step as jax_masked_relax_step
from repro.core.bfs_steps import relax_step as jax_relax_step
from repro.core.bfs_steps import unvisited_edge_count as jax_unvisited_edge_count
from repro.core.plan import BFSPlan as JaxPlan
from repro.core.plan import PreparedGraph as JaxPrepared
from repro.core.plan import compile_plan as jax_compile
from repro_torch import convert
from repro_torch.core import bfs_steps, hybrid_bfs, pipeline
from repro_torch.core.plan import BFSPlan, PreparedGraph, compile_plan

torch.set_num_threads(2)

_GRAPHS: dict = {}


def graphs(scale, edge_factor=16, n_roots=2):
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
        w, g = getattr(want.stats, f), getattr(got.stats, f)
        assert (w is None) == (g is None), f
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)


def compiled_pair(scale, edge_factor, engine, with_core):
    jb, tb, roots = graphs(scale, edge_factor)
    jg, tg = jb, tb
    if not with_core:
        jg = JaxPrepared(ev=jb.ev, degree=jb.degree, core=None)
        tg = PreparedGraph(ev=tb.ev, degree=tb.degree, core=None)
    jc = jax_compile(JaxPlan(engine=engine, layout=(), batch_roots=False), jg)
    tc = compile_plan(BFSPlan(engine=engine, layout=(), batch_roots=False), tg,
                      device="cpu")
    return jc, tc, roots


@pytest.mark.parametrize("scale,edge_factor", [(8, 16), (10, 16), (12, 16), (15, 1)])
@pytest.mark.parametrize("engine,with_core", [
    ("reference", False), ("legacy", True), ("legacy", False)])
def test_legacy_engines_bitwise_equal_to_jax(scale, edge_factor, engine, with_core):
    jc, tc, roots = compiled_pair(scale, edge_factor, engine, with_core)
    if scale == 8:
        assert graphs(8)[1].core.k > tc.num_vertices   # the padded core, K > V
    for r in roots:
        got = tc.bfs(int(r))
        assert_results_equal(got, jc.bfs(int(r)))
        assert got.stats.sentinel is None and int(got.stats.total_chunks) == 0
    if engine == "legacy" and with_core and scale != 8:
        assert (got.stats.direction == hybrid_bfs.BOTTOM_UP).any()


def test_legacy_engine_runs_core_spmv_every_bottom_up_level(monkeypatch):
    # one core_spmv call a bottom-up level, on a frontier packed that level
    jc, tc, roots = compiled_pair(12, 16, "legacy", True)
    calls = []
    real = hybrid_bfs.kops.core_spmv

    def recording(a_core, frontier_bm, **kw):
        calls.append(frontier_bm.clone())
        return real(a_core, frontier_bm, **kw)

    monkeypatch.setattr(hybrid_bfs.kops, "core_spmv", recording)
    got = tc.bfs(int(roots[0]))
    assert_results_equal(got, jc.bfs(int(roots[0])))
    n_bu = int((got.stats.direction == hybrid_bfs.BOTTOM_UP).sum())
    assert len(calls) == n_bu >= 1
    k = tc.graph.core.k
    bu_levels = np.nonzero(got.stats.direction.numpy() == hybrid_bfs.BOTTOM_UP)[0]
    for bm, lvl in zip(calls, bu_levels):
        frontier = torch.from_numpy(got.level.numpy()[:k] == lvl)
        assert torch.equal(bm, hybrid_bfs.pack_bitmap(frontier, k // 32))


@pytest.mark.parametrize("masked", [False, True])
def test_relax_steps_and_edge_counts_match_jax(masked):
    jb, tb, _ = graphs(10)
    v = jb.n_vertices
    rng = np.random.default_rng(4)
    frontier = rng.random(v) < 0.05
    visited = frontier | (rng.random(v) < 0.3)
    parent = np.full(v + 1, v, np.int32)
    parent[np.nonzero(visited)[0]] = np.nonzero(visited)[0]
    mask = rng.random(jb.ev.src.shape[0]) < 0.7
    t = torch.from_numpy
    if masked:
        want = jax_masked_relax_step(jb.ev, jnp.asarray(parent), jnp.asarray(frontier),
                                     jnp.asarray(visited), jnp.asarray(mask))
        got = bfs_steps.masked_relax_step(tb.ev, t(parent), t(frontier), t(visited),
                                          t(mask))
    else:
        want = jax_relax_step(jb.ev, jnp.asarray(parent), jnp.asarray(frontier),
                              jnp.asarray(visited))
        got = bfs_steps.relax_step(tb.ev, t(parent), t(frontier), t(visited))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].sum()) > 0
    deg = np.asarray(jb.degree)
    assert int(bfs_steps.frontier_edge_count(tb.degree, t(frontier))) == \
        int(jax_frontier_edge_count(jnp.asarray(deg), jnp.asarray(frontier)))
    assert int(bfs_steps.unvisited_edge_count(tb.degree, t(visited))) == \
        int(jax_unvisited_edge_count(jnp.asarray(deg), jnp.asarray(visited)))


@pytest.mark.parametrize("engine", ["reference", "legacy"])
@pytest.mark.parametrize("check", ["off", "post", "full"])
def test_compiled_legacy_run_matches_jax(engine, check):
    # the legacy engines carry no sentinel trace: "full" runs the spec
    # checks only, as in JAX
    jc, tc, roots = compiled_pair(10, 16, engine, True)
    jr = jc.run(roots, check=check)
    tr = tc.run(roots, check=check)
    np.testing.assert_array_equal(tr.parent, np.asarray(jr.parent))
    np.testing.assert_array_equal(tr.level, np.asarray(jr.level))
    assert tr.run.edges == jr.run.edges
    assert tr.run.check_counts == jr.run.check_counts
    assert "sentinel" not in tr.run.check_counts
    assert tr.run.validated == jr.run.validated
    assert tr.run.all_valid == (check != "off")


@pytest.mark.parametrize("rung", ["reference-3.0.0", "th2", "k", "pre-g500-legacy"])
def test_ladder_rungs_match_jax_pipeline(rung):
    jcfg = jpipe.Graph500Config.ladder(rung, scale=10, n_roots=2)
    jbuilt, jrun = jpipe.run(jcfg)
    edges = jkron.generate_edges(jcfg.seed, jcfg.scale, jcfg.edge_factor)
    roots = np.asarray(jkron.sample_roots(jcfg.seed, edges, jcfg.n_roots))
    cfg = pipeline.Graph500Config.ladder(rung, scale=10, n_roots=2, device="cpu")
    assert (cfg.engine, cfg.degree_sort, cfg.heavy_threshold, cfg.alpha, cfg.beta,
            cfg.batched) == (jcfg.engine, jcfg.degree_sort, jcfg.heavy_threshold,
                             jcfg.alpha, jcfg.beta, jcfg.batched)
    assert cfg.to_plan().to_dict() == jcfg.to_plan().to_dict()
    built = pipeline.build(cfg, edges=convert.edge_list_from_numpy(
        np.asarray(edges.src), np.asarray(edges.dst), edges.num_vertices, "cpu"))
    built, run = pipeline.run(cfg, built, roots=roots)
    assert (built.core is None) == (jbuilt.core is None)
    assert run.edges == jrun.edges
    assert run.all_valid and jrun.all_valid
    assert run.check_counts == jrun.check_counts
    keys = pipeline.search_keys(cfg, built, roots)
    tres = compile_plan(cfg.to_plan(), built, device="cpu").run(keys)
    jres = jax_compile(jcfg.to_plan(), jbuilt).run(keys)
    np.testing.assert_array_equal(tres.parent, np.asarray(jres.parent))
    np.testing.assert_array_equal(tres.level, np.asarray(jres.level))


def test_engines_agree_on_one_labelling():
    # invariant I4: on one labelling the engines are byte-identical
    _, tb, roots = graphs(12)
    res = {eng: compile_plan(BFSPlan(engine=eng, batch_roots=False), tb,
                             device="cpu").bfs(int(roots[1]))
           for eng in ("reference", "legacy", "bitmap")}
    for eng in ("reference", "legacy"):
        assert torch.equal(res[eng].parent, res["bitmap"].parent)
        assert torch.equal(res[eng].level, res["bitmap"].level)


@pytest.mark.parametrize("kw,match", [
    (dict(engine="legacy"), "batch_roots=True requires engine='bitmap'"),
    (dict(engine="reference", layout=("root",)), "requires engine='bitmap'"),
    (dict(partition="word_cyclic"), "vertex-sharded"),
    (dict(mesh_shape=(2,)), "mesh_shape given"),
    (dict(layout=("group", "member"), mesh_shape=(2,)), "one size per axis"),
    (dict(layout=("root",), mesh_shape=(0,)), "must be >= 1"),
    (dict(layout=("group", "member"), mesh_shape=(2, 3)), "power of two"),
])
def test_plan_rules_raise_value_error_as_in_jax(kw, match):
    _, tb, _ = graphs(10)
    from repro.core.plan import validate_plan as jax_validate_plan
    with pytest.raises(ValueError):
        jax_validate_plan(JaxPlan(**kw))
    with pytest.raises(ValueError, match=match):
        compile_plan(BFSPlan(**kw), tb, device="cpu")


def test_fault_on_a_legacy_engine_is_a_value_error():
    _, tb, _ = graphs(10)
    with pytest.raises(ValueError, match="fault injection requires engine='bitmap'"):
        compile_plan(BFSPlan(engine="legacy", batch_roots=False), tb, device="cpu",
                     fault=object())
