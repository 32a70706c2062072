"""The port's plan auto-tuner, topology planner and Fig. 12 host sorts
against the JAX package's.

Enumeration, the topology planner and the host sorts are pure: equal
outputs for equal inputs.  The sweeps of both packages run on JAX's
scale-8 edge list and roots (the port takes them through ``edges=`` and
``roots=``) under the deterministic cost model of ``tests/test_tune.py``:
the oracle parents, every candidate's status, the ranked order (ties
included) and the harmonic-mean TEPS must agree.  The port's sweep over a
virtual mesh of 4 shards (``devices=4``) is held the same way against
JAX's sweep on 4 forced host devices, run once in a subprocess.  The tuned
tables use one layout, so each package reads the other's (a virtual
entry's ``"virtual"`` field included).
"""
import dataclasses
import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.comms import topology as jtopo
from repro.core import kronecker as jkron
from repro.core import pipeline as jpipe
from repro.core import reorder as jreorder
from repro.core import tune as jtune
from repro.core.plan import BFSPlan as JaxPlan
from repro.core.plan import compile_plan as jax_compile
from repro.serve import engine as jengine
from repro.util import respawn_with_host_devices
from repro_torch import convert
from repro_torch.comms import topology
from repro_torch.core import pipeline, reorder, tune
from repro_torch.core.plan import BFSPlan, compile_plan
from repro_torch.serve import engine

torch.set_num_threads(2)

SCALE, SEED, N_ROOTS = 8, 3, 2
N_DEVICES = (1, 2, 4, 6, 8)

_CACHE: dict = {}


def _cost_model(compiled, roots, reps):
    """The stand-in clock of ``tests/test_tune.py``: cost from the plan's
    declarative fields only."""
    p = compiled.plan
    return 1.0 + 0.1 * p.n_chunks / 64.0 + (0.5 if p.alpha < 10 else 0.0)


def jax_edges():
    """JAX's scale-8 edge list and root sample (original labels)."""
    if "edges" not in _CACHE:
        e = jkron.generate_edges(SEED, SCALE, 16)
        roots = np.asarray(jkron.sample_roots(SEED, e, N_ROOTS))
        _CACHE["edges"] = (e, convert.edge_list_from_numpy(
            np.asarray(e.src), np.asarray(e.dst), e.num_vertices, device="cpu"),
            roots)
    return _CACHE["edges"]


def sweep_plans():
    """One device's full candidate set, plus one plan for each way a
    candidate can be refused (too many devices, a non-pow2 member axis) and
    the one mesh layout that fits one device, the 1-shard root mesh."""
    extra = [dict(layout=("group", "member"), mesh_shape=(16, 16)),
             dict(layout=("group", "member"), mesh_shape=(2, 3)),
             dict(layout=("root",), mesh_shape=(1,))]
    plans = tune.enumerate_plans(1, tune.BUDGETS["full"])
    return plans + [BFSPlan(**kw) for kw in extra]


def sweeps():
    """(JAX report, port report) on the same inputs and candidates."""
    if "sweeps" not in _CACHE:
        je, te, roots = jax_edges()
        plans = sweep_plans()
        jr = jtune.sweep(SCALE, seed=SEED, n_roots=N_ROOTS, reps=1,
                         plans=[JaxPlan.from_dict(p.to_dict()) for p in plans],
                         measure=_cost_model, log=lambda s: None)
        tr = tune.sweep(SCALE, seed=SEED, n_roots=N_ROOTS, reps=1, plans=plans,
                        measure=_cost_model, log=lambda s: None, device="cpu",
                        edges=te, roots=roots)
        _CACHE["sweeps"] = (jr, tr)
    return _CACHE["sweeps"]


# ---------------------------------------------------------------------------
# Search space and the topology planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", sorted(tune.BUDGETS))
@pytest.mark.parametrize("n", N_DEVICES)
def test_enumerate_plans_equal_to_jax(n, budget):
    got = [p.to_dict() for p in tune.enumerate_plans(n, tune.BUDGETS[budget])]
    want = [p.to_dict() for p in jtune.enumerate_plans(n, jtune.BUDGETS[budget])]
    assert got == want
    assert tune.BUDGETS[budget] == tune.TuneBudget(
        **dataclasses.asdict(jtune.BUDGETS[budget]))


def test_single_device_candidate_counts():
    # 1 / 4 / 12 candidates on one card, α/β × n_chunks of layout=()
    counts = {b: len(tune.enumerate_plans(1, tune.BUDGETS[b])) for b in tune.BUDGETS}
    assert counts == {"small": 1, "medium": 4, "full": 12}
    assert all(p.layout == () and p.batch_roots
               for p in tune.enumerate_plans(1, tune.BUDGETS["full"]))
    assert tune.SCHEMA_VERSION == jtune.SCHEMA_VERSION


def test_plan_device_mesh_equal_to_jax():
    for n in range(1, 65):
        assert topology.plan_device_mesh(n) == jtopo.plan_device_mesh(n), n
    t = topology.TreeTopology((2, 3, 2))
    assert topology.plan_device_mesh(12, t) == jtopo.plan_device_mesh(
        12, jtopo.TreeTopology((2, 3, 2)))
    with pytest.raises(ValueError, match="n_devices must be >= 1"):
        topology.plan_device_mesh(0)


def test_tree_topology_equal_to_jax():
    t, jt = topology.TreeTopology(), jtopo.TreeTopology()
    assert (t.n_nodes, t.group_size, t.n_groups) == (jt.n_nodes, jt.group_size,
                                                    jt.n_groups)
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, t.n_nodes, 300), rng.integers(0, t.n_nodes, 300)
    np.testing.assert_array_equal(t.level(a, b), jt.level(a, b))
    np.testing.assert_array_equal(t.hops(a, b), jt.hops(a, b))
    got, want = t.hop_breakdown(a, b), jt.hop_breakdown(a, b)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("policy", ["random", "heaviest", "orchestra"])
def test_elect_monitors_equal_to_jax(policy):
    fan = (4, 4, 2)
    t, jt = topology.TreeTopology(fan), jtopo.TreeTopology(fan)
    w = np.random.default_rng(11).pareto(1.5, t.n_nodes)
    mp = topology.elect_monitors(t, w, policy, seed=4)
    jp = jtopo.elect_monitors(jt, w, policy, seed=4)
    np.testing.assert_array_equal(mp.monitors, jp.monitors)
    assert mp.policy == jp.policy
    src, dst = topology.simulate_messages(500, t, seed=2, skew=w)
    np.testing.assert_array_equal(mp.route_hops(src, dst), jp.route_hops(src, dst))
    assert mp.batched_route_hops(src, dst) == jp.batched_route_hops(src, dst)
    with pytest.raises(ValueError, match="unknown policy"):
        topology.elect_monitors(t, w, "loudest")


@pytest.mark.parametrize("skewed", [False, True])
def test_simulate_messages_equal_to_jax(skewed):
    t, jt = topology.TreeTopology(), jtopo.TreeTopology()
    skew = np.random.default_rng(1).pareto(1.2, t.n_nodes) if skewed else None
    for got, want in zip(topology.simulate_messages(1000, t, seed=9, skew=skew),
                         jtopo.simulate_messages(1000, jt, seed=9, skew=skew)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The sweep on JAX's edge list
# ---------------------------------------------------------------------------

def test_sweep_inputs_and_oracle_equal_to_jax():
    je, te, roots = jax_edges()
    jpg, jdeg, jroots, jv = jtune._build_inputs(SCALE, SEED, 16, N_ROOTS)
    pg, deg, troots, v = tune._build_inputs(SCALE, SEED, 16, N_ROOTS, "cpu",
                                            edges=te, roots=roots)
    assert v == jv
    np.testing.assert_array_equal(troots, np.asarray(jroots))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jdeg))
    assert pg.core.k == jpg.core.k and pg.core.threshold == jpg.core.threshold == 8
    oracle = compile_plan(BFSPlan(layout=(), batch_roots=True), pg, device="cpu")
    joracle = jax_compile(JaxPlan(layout=(), batch_roots=True), jpg)
    np.testing.assert_array_equal(oracle.bfs(troots).parent.numpy(),
                                  np.asarray(joracle.bfs(jroots).parent))


def test_sweep_statuses_equal_to_jax():
    jr, tr = sweeps()
    plans = sweep_plans()
    status = {tune._plan_sort_key(r.plan): (r.status, r.reason)
              for r in tr.results + tr.skipped}
    jstatus = {jtune._plan_sort_key(r.plan): (r.status, r.reason)
               for r in jr.results + jr.skipped}
    assert len(status) == len(jstatus) == len(plans)
    fits = tune._plan_sort_key(BFSPlan(layout=("root",), mesh_shape=(1,)))
    # the 1-device root mesh compiles and is swept, as in JAX
    assert status[fits][0] == jstatus[fits][0] == "ok"
    for key, (st, why) in status.items():
        assert st == jstatus[key][0], key
        if st == "skipped":
            # JAX's text, less what names JAX's means (XLA_FLAGS, mesh=)
            assert jstatus[key][1].startswith(why.split(" — ")[0]), (why, jstatus[key])
    skipped = {r.plan.mesh_shape: r.reason for r in tr.skipped}
    assert "needs 256 devices, have 1" in skipped[(16, 16)]
    assert "power of two" in skipped[(2, 3)]
    assert len(tr.results) == 13 and all(r.identical for r in tr.results)
    assert (tr.n_devices, tr.backend, tr.interpret_mode) == (1, "cpu", True)


def test_sweep_ranked_order_and_hmean_equal_to_jax():
    jr, tr = sweeps()
    want = jr.results
    assert [r.plan.layout for r in want].count(("root",)) == 1
    assert [r.plan.to_dict() for r in tr.results] == [r.plan.to_dict() for r in want]
    # the model ties α = 14's two β per n_chunks: the plan's JSON breaks them
    costs = [r.per_root_us for r in tr.results]
    assert len(set(costs)) < len(costs)
    for got, w in zip(tr.results, want):
        assert got.per_root_us == w.per_root_us
        assert got.harmonic_mean_teps == pytest.approx(w.harmonic_mean_teps,
                                                       rel=1e-9)
        assert got.harmonic_mean_teps > 0
    assert tr.winner.plan.to_dict() == want[0].plan.to_dict()
    table = tr.table().splitlines()
    assert table[1] == jr.table().splitlines()[1]
    assert table[2].startswith("1,single,1,hier_or,block,14,24,16,")


def test_sweep_is_deterministic_and_releases_candidates(monkeypatch):
    # a second sweep ranks the same; every compiled candidate is dropped
    # once timed (a weakref to it dies before the next one compiles)
    import weakref
    je, te, roots = jax_edges()
    alive = []

    def cost(compiled, r, reps):
        alive.append(weakref.ref(compiled))
        assert all(w() is None for w in alive[:-1])
        return _cost_model(compiled, r, reps)

    plans = tune.enumerate_plans(1, tune.BUDGETS["medium"])
    rep = tune.sweep(SCALE, seed=SEED, n_roots=N_ROOTS, reps=1, plans=plans,
                     measure=cost, log=lambda s: None, device="cpu", edges=te,
                     roots=roots)
    assert len(alive) == 4
    order = [r.plan for r in rep.results]
    assert order == [r.plan for r in tune.sweep(
        SCALE, seed=SEED, n_roots=N_ROOTS, reps=1, plans=plans,
        measure=_cost_model, log=lambda s: None, device="cpu", edges=te,
        roots=roots).results]
    # each candidate kept the chunking it was compiled with
    assert {r.plan.n_chunks for r in rep.results} == {16, 64}


def test_sweep_records_rejected_and_failed(monkeypatch):
    je, te, roots = jax_edges()
    plans = [BFSPlan(layout=(), batch_roots=True, n_chunks=16),
             BFSPlan(layout=(), batch_roots=True, n_chunks=32)]

    def crash(compiled, r, reps):
        if compiled.plan.n_chunks == 32:
            raise RuntimeError("boom")
        return 1.0

    rep = tune.sweep(SCALE, seed=SEED, n_roots=N_ROOTS, reps=1, plans=plans,
                     measure=crash, log=lambda s: None, device="cpu", edges=te,
                     roots=roots)
    assert [r.plan.n_chunks for r in rep.results] == [16]
    assert [(r.status, r.reason) for r in rep.skipped] == [
        ("failed", "measurement raised RuntimeError: boom")]
    # a candidate whose parents diverge from the oracle is never timed
    real = tune.compile_plan

    def corrupt(plan, pg, device=None, mesh=None):
        c = real(plan, pg, device=device, mesh=mesh)
        if plan.n_chunks != 16:     # the oracle (n_chunks=64) stays clean
            return c
        bfs = c.bfs

        def bad(r):
            res = bfs(r)
            return res._replace(parent=torch.flip(res.parent, [0]))
        c.bfs = bad
        return c

    monkeypatch.setattr(tune, "compile_plan", corrupt)
    rep = tune.sweep(SCALE, seed=SEED, n_roots=N_ROOTS, reps=1, plans=plans[:1],
                     measure=crash, log=lambda s: None, device="cpu", edges=te,
                     roots=roots)
    assert rep.winner is None
    assert rep.skipped[0].status == "rejected"
    assert "parents diverge" in rep.skipped[0].reason


def test_default_measure_times_the_batch():
    je, te, roots = jax_edges()
    pg, _, troots, _ = tune._build_inputs(SCALE, SEED, 16, N_ROOTS, "cpu",
                                          edges=te, roots=roots)
    c = compile_plan(BFSPlan(layout=(), batch_roots=True), pg, device="cpu")
    wall = tune._default_measure(c, troots, 2)
    assert 0 < wall < 60


# ---------------------------------------------------------------------------
# The tuned-plan table
# ---------------------------------------------------------------------------

def _report(mod, plan_cls, scale=12, n_devices=8, backend="cpu", plan=None):
    plan = plan or plan_cls(layout=("root",), mesh_shape=(4,))
    return mod.TuneReport(
        scale=scale, n_devices=n_devices, backend=backend,
        interpret_mode=True, budget="small", seed=1, n_roots=4, reps=2,
        results=[mod.TuneResult(plan, "ok", wall_s=1.0, per_root_us=2.5e5,
                                harmonic_mean_teps=1e5, identical=True)])


def report(**kw):
    return _report(tune, BFSPlan, **kw)


def test_table_path_and_env(monkeypatch, tmp_path):
    monkeypatch.delenv(tune.TABLE_ENV, raising=False)
    monkeypatch.setenv("REPRO_TUNED_PLANS", str(tmp_path / "jax.json"))
    assert tune.table_path() == tune.DEFAULT_TABLE
    assert tune.DEFAULT_TABLE.endswith("TUNED_PLANS_torch.json")
    monkeypatch.setenv("REPRO_TORCH_TUNED_PLANS", str(tmp_path / "t.json"))
    assert tune.table_path() == str(tmp_path / "t.json")
    assert tune.table_path("x.json") == "x.json"


def test_table_round_trip_and_merge(tmp_path):
    path = str(tmp_path / "t.json")
    assert tune.save_tuned(report(), path) == path
    assert tune.load_table(path)["schema_version"] == tune.SCHEMA_VERSION
    assert tune.tuned_plan(12, 8, "cpu", path=path) == BFSPlan(
        layout=("root",), mesh_shape=(4,))
    tune.save_tuned(report(scale=14, plan=BFSPlan(layout=(), batch_roots=True)),
                    path)
    assert tune.tuned_plan(12, 8, "cpu", path=path) is not None
    assert tune.tuned_plan(14, 8, "cpu", path=path).layout == ()
    assert sorted(tune.load_table(path)["entries"]) == [
        "scale12/dev8/cpu", "scale14/dev8/cpu"]
    with pytest.raises(ValueError, match="no accepted winner"):
        tune.save_tuned(tune.TuneReport(12, 1, "cpu", True, "small", 1, 2, 1), path)


@pytest.mark.parametrize("version", [1, 3])
def test_schema_rejection_and_no_overwrite(tmp_path, version):
    path = str(tmp_path / "t.json")
    tune.save_tuned(report(), path)
    doc = json.load(open(path))
    doc["schema_version"] = version
    if version == 1:
        for entry in doc["entries"].values():
            entry["plan"].pop("partition", None)
    json.dump(doc, open(path, "w"))
    with pytest.raises(ValueError, match="schema_version") as ei:
        tune.load_table(path)
    msg = str(ei.value)
    assert "repro_torch.core.tune" in msg
    assert ("partition" in msg) == (version == 1)
    assert ("newer plan schema" in msg) == (version == 3)
    with pytest.raises(ValueError, match="schema_version"):
        tune.tuned_plan(12, 8, "cpu", path=path)
    # a foreign-schema table is never clobbered by a new sweep
    with pytest.raises(ValueError, match="schema_version"):
        tune.save_tuned(report(scale=14), path)
    assert json.load(open(path))["schema_version"] == version


def test_tuned_plan_misses_overrides_and_kernel(tmp_path):
    path = str(tmp_path / "t.json")
    assert tune.tuned_plan(12, 8, "cpu", path=path) is None
    tune.save_tuned(report(), path)
    assert tune.tuned_plan(13, 8, "cpu", path=path) is None
    assert tune.tuned_plan(12, 4, "cpu", path=path) is None
    assert tune.tuned_plan(12, 8, "cuda", path=path) is None
    got = tune.tuned_plan(12, 8, "cpu", path=path,
                          overrides={"exchange": "flat", "alpha": 9.0})
    assert got.exchange == "flat" and got.alpha == 9.0 and got.mesh_shape == (4,)
    want = jtune.tuned_plan(12, 8, "cpu", path=path,
                            overrides={"exchange": "flat", "alpha": 9.0})
    assert got.to_dict() == want.to_dict()
    ss = tune.tuned_plan(12, 8, "cpu", path=path, kernel="sssp")
    assert ss.to_dict() == jtune.tuned_plan(12, 8, "cpu", path=path,
                                            kernel="sssp").to_dict()
    assert (ss.kernel, ss.exchange, ss.mesh_shape) == ("sssp", "hier_min", (4,))


def test_tuned_exchange_nearest_scale_and_default(tmp_path):
    path = str(tmp_path / "t.json")
    assert tune.tuned_exchange(22, 256, path=path) == ("hier_or", "default")
    tune.save_tuned(report(plan=BFSPlan(layout=("group", "member"),
                                        mesh_shape=(2, 4),
                                        exchange="hier_gather")), path)
    for args in ((22, 256), (12, 8, "cpu"), (12, 8), (12, 8, "cuda"), (9,)):
        got = tune.tuned_exchange(*args, path=path)
        assert got == jtune.tuned_exchange(*args, path=path), args
    assert tune.tuned_exchange(22, 256, path=path) == (
        "hier_gather", "tuned:nearest_scale12")
    assert tune.tuned_exchange(12, 8, "cpu", path=path) == (
        "hier_gather", "tuned:scale12/dev8/cpu")


def _entries(path):
    doc = json.load(open(path))
    for e in doc["entries"].values():
        e.pop("created_unix")
        e.pop("interpret_mode")
    return doc


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_each_package_reads_the_others_table(tmp_path, writer):
    path = str(tmp_path / "t.json")
    plans = (dict(layout=(), batch_roots=True, alpha=9.0, n_chunks=32),
             dict(layout=("group", "member"), mesh_shape=(2, 4),
                  partition="word_cyclic", exchange="hier_gather"))
    w, wplan = (jtune, JaxPlan) if writer == "repro" else (tune, BFSPlan)
    r, rplan = (tune, BFSPlan) if writer == "repro" else (jtune, JaxPlan)
    for i, kw in enumerate(plans):
        w.save_tuned(_report(w, wplan, scale=10 + i, n_devices=1, backend="cuda",
                             plan=wplan(**kw)), path)
    doc = r.load_table(path)
    assert sorted(doc["entries"]) == ["scale10/dev1/cuda", "scale11/dev1/cuda"]
    for i, kw in enumerate(plans):
        assert r.tuned_plan(10 + i, 1, "cuda", path=path).to_dict() == \
            rplan(**kw).to_dict()
    # the reader re-saves through its own save_tuned: same layout
    other = str(tmp_path / "o.json")
    for i, kw in enumerate(plans):
        r.save_tuned(_report(r, rplan, scale=10 + i, n_devices=1, backend="cuda",
                             plan=rplan(**kw)), other)
    assert _entries(other) == _entries(path)


# ---------------------------------------------------------------------------
# Consumers: the pre-g500-tuned rung and the serving plan
# ---------------------------------------------------------------------------

def test_pipeline_tuned_rung_consumes_table(tmp_path, monkeypatch):
    path = str(tmp_path / "t.json")
    table_plan = BFSPlan(layout=(), batch_roots=True, alpha=9.0, beta=48.0,
                         n_chunks=32)
    tune.save_tuned(report(scale=10, n_devices=1, backend="cpu", plan=table_plan),
                    path)
    monkeypatch.setenv("REPRO_TORCH_TUNED_PLANS", path)

    def lad(**kw):
        return pipeline.Graph500Config.ladder("pre-g500-tuned", device="cpu", **kw)

    cfg = lad(scale=10)
    assert cfg.tuned and cfg.batched
    assert cfg.to_plan() == table_plan                  # table wins
    assert lad(scale=10, alpha=11.0).to_plan() == dataclasses.replace(
        table_plan, alpha=11.0)
    assert lad(scale=9).to_plan() == BFSPlan(layout=(), batch_roots=True)
    assert lad(scale=10, layout=()).to_plan().alpha == 14.0
    assert lad(scale=10, mesh_shape=(1,)).to_plan().alpha == 14.0
    # the card's key is another entry: a cuda config misses this table
    assert pipeline.Graph500Config.ladder(
        "pre-g500-tuned", scale=10).to_plan() == BFSPlan(layout=(), batch_roots=True)
    assert lad(scale=10, kernel="sssp").to_plan() == dataclasses.replace(
        table_plan, kernel="sssp")
    # the same cases through the JAX package, on its own key
    import jax
    jpath = str(tmp_path / "j.json")
    jtune.save_tuned(_report(jtune, JaxPlan, scale=10, n_devices=len(jax.devices()),
                             backend=jax.default_backend(),
                             plan=JaxPlan(**table_plan.to_dict())), jpath)
    monkeypatch.setenv("REPRO_TUNED_PLANS", jpath)
    for kw in (dict(scale=10), dict(scale=10, alpha=11.0), dict(scale=9),
               dict(scale=10, layout=()), dict(scale=10, beta=30.0)):
        got = lad(**kw).to_plan().to_dict()
        assert got == jpipe.Graph500Config.ladder(
            "pre-g500-tuned", **kw).to_plan().to_dict(), kw


def test_mesh_config_knobs_lower_like_jax():
    for kw in (dict(root_devices=2, batched=True), dict(root_devices=0, batched=True),
               dict(layout=("group", "member"), mesh_shape=(2, 2),
                    partition="word_cyclic", exchange="flat"),
               dict(exchange="hier_gather")):
        got = pipeline.Graph500Config(**kw).to_plan().to_dict()
        assert got == jpipe.Graph500Config(**kw).to_plan().to_dict(), kw
    with pytest.raises(ValueError, match="root_devices requires batched=True"):
        pipeline.Graph500Config(root_devices=2).to_plan()
    # the mesh rungs are ported: they lower to JAX's plans
    for rung in ("pre-g500-mesh", "pre-g500-mesh3"):
        for kw in ({}, dict(mesh_shape=(2, 2, 2)) if rung.endswith("3") else
                   dict(root_devices=4)):
            got = pipeline.Graph500Config.ladder(rung, **kw).to_plan().to_dict()
            assert got == jpipe.Graph500Config.ladder(rung, **kw).to_plan().to_dict()


def test_pipeline_tuned_rung_runs_valid_without_table(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_TUNED_PLANS", str(tmp_path / "missing.json"))
    cfg = pipeline.Graph500Config.ladder("pre-g500-tuned", scale=9, n_roots=2,
                                         device="cpu")
    _, result = pipeline.run(cfg)
    assert result.batched and result.all_valid
    assert result.harmonic_mean_teps > 0


def test_resolve_serve_plan_hits_and_misses(monkeypatch, tmp_path):
    import jax
    path = str(tmp_path / "t.json")
    jpath = str(tmp_path / "j.json")
    table_plan = BFSPlan(layout=(), batch_roots=False, alpha=8.0, beta=64.0,
                         n_chunks=16)
    tune.save_tuned(report(scale=10, n_devices=1, backend="cpu", plan=table_plan),
                    path)
    jtune.save_tuned(_report(jtune, JaxPlan, scale=10, n_devices=len(jax.devices()),
                             backend=jax.default_backend(),
                             plan=JaxPlan(**table_plan.to_dict())), jpath)
    monkeypatch.setenv("REPRO_TORCH_TUNED_PLANS", path)
    monkeypatch.setenv("REPRO_TUNED_PLANS", jpath)
    for scale, ov in ((10, None), (10, {"alpha": 7.0}), (11, None),
                      (11, {"beta": 30.0}), (None, {"n_chunks": 8})):
        got = engine.resolve_serve_plan(scale, ov, device="cpu")
        want = jengine.resolve_serve_plan(scale, ov)
        assert got.to_dict() == want.to_dict(), (scale, ov)
        assert got.batch_roots
    hit = engine.resolve_serve_plan(10, device="cpu")
    assert hit == dataclasses.replace(table_plan, batch_roots=True)
    # the card's key misses a CPU table
    assert engine.resolve_serve_plan(10) == BFSPlan(layout=(), batch_roots=True)
    je, te, roots = jax_edges()
    pg, _, _, _ = tune._build_inputs(SCALE, SEED, 16, N_ROOTS, "cpu", edges=te,
                                     roots=roots)
    eng = engine.Engine(pg, scale=10, device="cpu",
                        config=engine.ServeConfig(warmup=False))
    assert eng.plan == hit


# ---------------------------------------------------------------------------
# Fig. 12 host sorts and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["xla", "merge", "quick", "bubble"])
def test_sort_host_equal_to_jax(algorithm):
    rng = np.random.default_rng(7)
    for n in (0, 1, 2, 37, 300):
        degree = rng.integers(0, 6, n).astype(np.int32)   # many ties
        got = reorder.sort_host(degree, algorithm)
        np.testing.assert_array_equal(got, jreorder.sort_host(degree, algorithm))
        # degree-descending, ties by id (every algorithm here is stable)
        np.testing.assert_array_equal(got, np.argsort(-degree.astype(np.int64),
                                                      kind="stable"))
    with pytest.raises(KeyError):
        reorder.sort_host(np.zeros(3, np.int32), "shell")


def test_cli_sweep_on_cpu_emits_table_and_persists(tmp_path, capsys):
    out_path = str(tmp_path / "t.json")
    rc = tune.main(["--scale", str(SCALE), "--budget", "medium", "--seed", "3",
                    "--roots", "2", "--reps", "1", "--device", "cpu",
                    "--out", out_path])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "rank,layout,mesh" in printed and "\n1," in printed
    assert "interpret=True" in printed and "[scale8/dev1/cpu]" in printed
    got = tune.tuned_plan(SCALE, 1, "cpu", path=out_path)
    assert got is not None and got.batch_roots and got.layout == ()
    entry = tune.load_table(out_path)["entries"]["scale8/dev1/cpu"]
    assert entry["identical"] and len(entry["ranked"]) == 4
    rc = tune.main(["--scale", str(SCALE), "--device", "cpu", "--roots", "2",
                    "--reps", "1", "--no-save", "--out", str(tmp_path / "n.json")])
    assert rc == 0 and not (tmp_path / "n.json").exists()


# ---------------------------------------------------------------------------
# The sweep over N shards: a virtual mesh against JAX's forced host devices
# ---------------------------------------------------------------------------

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")

JAX_SWEEP4 = """
import json, sys
import numpy as np
import jax
from repro.core import tune
from repro.core.plan import BFSPlan, compile_plan

scale, seed, n_roots, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]

def cost(compiled, roots, reps):
    p = compiled.plan
    return 1.0 + 0.1 * p.n_chunks / 64.0 + (0.5 if p.alpha < 10 else 0.0)

rep = tune.sweep(scale, seed=seed, n_roots=n_roots, reps=1, measure=cost,
                 log=lambda s: None)
pg, degree, roots, v = tune._build_inputs(scale, seed, 16, n_roots)
oracle = np.asarray(compile_plan(BFSPlan(layout=(), batch_roots=True), pg).bfs(roots).parent)
np.save(out + ".npy", oracle)
json.dump(dict(n_devices=len(jax.devices()), table=rep.table(),
               results=[r.to_dict() for r in rep.results],
               skipped=[r.to_dict() for r in rep.skipped]), open(out + ".json", "w"))
print("OK")
"""


@pytest.fixture(scope="module")
def jax_sweep4(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_sweep4") / "ref")
    proc = respawn_with_host_devices(
        [sys.executable, "-c", textwrap.dedent(JAX_SWEEP4), str(SCALE), str(SEED),
         str(N_ROOTS), out], 4, extra_env={"JAX_PLATFORMS": "cpu"},
        pythonpath=(REPO_SRC,), capture=True, timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    with open(out + ".json") as f:
        return json.load(f), np.load(out + ".npy")


def virtual_sweep4():
    if "sweep4" not in _CACHE:
        je, te, roots = jax_edges()
        _CACHE["sweep4"] = tune.sweep(
            SCALE, seed=SEED, n_roots=N_ROOTS, reps=1, measure=_cost_model,
            log=lambda s: None, device="cpu", edges=te, roots=roots, devices=4)
    return _CACHE["sweep4"]


def test_virtual_sweep_statuses_order_and_oracle_equal_to_jax_devices(jax_sweep4):
    want, oracle = jax_sweep4
    rep = virtual_sweep4()
    assert want["n_devices"] == rep.n_devices == 4 and rep.virtual
    assert (rep.backend, rep.interpret_mode) == ("cpu", True)
    plans = tune.enumerate_plans(4, tune.BUDGETS["small"])
    assert len(plans) == 15 == len(want["results"]) + len(want["skipped"])
    assert [r.to_dict() for r in rep.results] == want["results"]
    assert [r.to_dict() for r in rep.skipped] == want["skipped"]
    assert all(r.status == "ok" and r.identical for r in rep.results)
    assert {r.plan.layout for r in rep.results} == {
        (), ("root",), ("group", "member"), ("root", "group", "member")}
    # the ranked table: the same rows; the port's header names the virtual mesh
    got_t, want_t = rep.table().splitlines(), want["table"].splitlines()
    assert got_t[1:] == want_t[1:]
    assert got_t[0].endswith("virtual=True") and "devices=4" in got_t[0]
    je, te, roots = jax_edges()
    pg, _, troots, _ = tune._build_inputs(SCALE, SEED, 16, N_ROOTS, "cpu", edges=te,
                                          roots=roots)
    got = compile_plan(BFSPlan(layout=(), batch_roots=True), pg, device="cpu").bfs(troots)
    np.testing.assert_array_equal(got.parent.numpy(), oracle)


def test_virtual_sweep_candidates_compile_on_virtual_meshes(monkeypatch):
    # every layout candidate gets a virtual mesh of its shape (the plan's,
    # or the one derived for 4 devices); a shape the 4 shards cannot hold
    # and a non-pow2 member are skipped
    seen = []
    real = tune.compile_plan

    def spy(plan, pg, device=None, mesh=None):
        seen.append((plan.layout, None if mesh is None else
                     (mesh.shape, set(mesh.devices), len(mesh.devices))))
        return real(plan, pg, device=device, mesh=mesh)

    monkeypatch.setattr(tune, "compile_plan", spy)
    je, te, roots = jax_edges()
    plans = [BFSPlan(layout=("group", "member"), mesh_shape=(2, 2), batch_roots=True),
             BFSPlan(layout=("root",), batch_roots=True),
             BFSPlan(layout=("group", "member"), mesh_shape=(4, 2), batch_roots=True),
             BFSPlan(layout=("group", "member"), mesh_shape=(1, 3), batch_roots=True)]
    rep = tune.sweep(SCALE, seed=SEED, n_roots=N_ROOTS, reps=1, plans=plans,
                     measure=_cost_model, log=lambda s: None, device="cpu", edges=te,
                     roots=roots, devices=4)
    cpu = {torch.device("cpu")}
    # (the non-pow2 member is refused by compile_plan's plan validation)
    assert seen[1:] == [(("group", "member"), ((2, 2), cpu, 4)),
                        (("root",), ((4,), cpu, 4)),
                        (("group", "member"), ((1, 3), cpu, 3))]
    assert [r.status for r in rep.results] == ["ok", "ok"]
    reasons = [r.reason for r in rep.skipped]
    assert "needs 8 devices, have 4" in reasons[0] and "power of two" in reasons[1]


def test_virtual_sweep_partitions_each_shard_layout_once(monkeypatch):
    # candidates that differ only in their exchange reuse one partition:
    # (1, 4) and (2, 1, 2) x two partitions -> 4 partitions for 12 candidates
    from repro_torch.core import plan as plan_mod
    calls = []
    real = plan_mod.shard_graph

    def counting(*a, **kw):
        calls.append((a[4], kw.get("partition")))
        return real(*a, **kw)

    monkeypatch.setattr(plan_mod, "shard_graph", counting)
    je, te, roots = jax_edges()
    rep = tune.sweep(SCALE, seed=SEED, n_roots=N_ROOTS, reps=1, measure=_cost_model,
                     log=lambda s: None, device="cpu", edges=te, roots=roots, devices=4)
    assert sorted(calls) == [(2, "block"), (2, "word_cyclic"), (4, "block"),
                             (4, "word_cyclic")]
    assert [r.to_dict() for r in rep.results] == \
        [r.to_dict() for r in virtual_sweep4().results]


def test_virtual_entry_is_dev4_and_read_by_jax(tmp_path):
    path = str(tmp_path / "t.json")
    rep = virtual_sweep4()
    tune.save_tuned(rep, path)
    entry = tune.load_table(path)["entries"]["scale8/dev4/cpu"]
    assert entry["virtual"] is True and entry["n_devices"] == 4
    for mod in (tune, jtune):
        got = mod.tuned_plan(SCALE, 4, "cpu", path=path)
        assert got is not None and got.to_dict() == rep.winner.plan.to_dict()
    # a sweep over the visible devices writes no such field, as JAX's
    tune.save_tuned(report(scale=8, n_devices=1), path)
    assert "virtual" not in tune.load_table(path)["entries"]["scale8/dev1/cpu"]


def test_cli_virtual_devices_on_cpu(tmp_path, capsys):
    out_path = str(tmp_path / "t.json")
    rc = tune.main(["--scale", str(SCALE), "--seed", "3", "--roots", "2", "--reps", "1",
                    "--devices", "4", "--device", "cpu", "--out", out_path])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "devices=4" in printed and "virtual=True" in printed
    assert "[scale8/dev4/cpu]" in printed and "group*member,1x4" in printed
    entry = tune.load_table(out_path)["entries"]["scale8/dev4/cpu"]
    assert entry["virtual"] and entry["identical"] and entry["n_skipped"] == 0
