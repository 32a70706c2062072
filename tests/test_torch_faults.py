"""The port's fault injection and checked execution against the JAX package.

Both packages get the same graph (JAX's edge view, degree and heavy core
carried into the port as numpy) and the same :class:`FaultSpec`.  Detection,
the retry -> degraded fallback -> quarantine recovery and the corrupted
trees themselves must agree: check counts, failure attribution, retries,
fallbacks, quarantined roots, validated flags, and parents and levels (SSSP:
distances) bit for bit.  The legs are the single-device ones of
``tests/test_faults.py`` and the SSSP quarantine of ``tests/test_sssp.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_csr as jax_build_csr
from repro.core import build_heavy_core as jax_build_heavy_core
from repro.core import degree_reorder as jax_degree_reorder
from repro.core import edge_view as jax_edge_view
from repro.core import faults as jfaults
from repro.core import generate_edges as jax_generate_edges
from repro.core import validate as jax_validate
from repro.core.bfs_steps import with_edge_weights as jax_with_edge_weights
from repro.core.hybrid_bfs import BFSResult as JaxBFSResult
from repro.core.plan import PreparedGraph as JaxPrepared
from repro.core.plan import TraversalPlan as JaxPlan
from repro.core.plan import compile_plan as jax_compile
from repro.core.reorder import relabel_edges as jax_relabel_edges
from repro_torch import convert
from repro_torch.core import faults
from repro_torch.core.hybrid_bfs import BFSResult
from repro_torch.core.plan import PreparedGraph, TraversalPlan, compile_plan
from repro_torch.core.validate import validate, validate_batch

torch.set_num_threads(2)

ROOTS = np.arange(4, dtype=np.int32)
_GRAPHS: dict = {}


def graphs(kernel="bfs"):
    """(JAX prepared graph, port prepared graph), cached.  BFS: scale 9,
    seed 11, core threshold 32 (``tests/test_faults.py``); SSSP: the same
    edges, weights seeded 1, no core (``tests/test_sssp.py``)."""
    if kernel not in _GRAPHS:
        edges = jax_generate_edges(11, 9)
        g0 = jax_build_csr(edges)
        g = jax_build_csr(jax_relabel_edges(edges, jax_degree_reorder(g0.degree)))
        ev = jax_edge_view(g)
        core = None
        if kernel == "sssp":
            ev = jax_with_edge_weights(ev, seed=1)
        else:
            core = jax_build_heavy_core(g, threshold=32)
        jp = JaxPrepared(ev=ev, degree=g.degree, core=core)
        tb = convert.built_from_numpy(
            np.asarray(ev.src), np.asarray(ev.dst), np.asarray(ev.valid),
            np.asarray(g.degree), num_vertices=ev.num_vertices,
            a_core=None if core is None else np.asarray(core.a_core),
            k_heavy=None if core is None else int(core.k_heavy), threshold=32,
            weight=None if ev.weight is None else np.asarray(ev.weight),
            device="cpu")
        tp = PreparedGraph(ev=tb.ev, degree=tb.degree, core=tb.core)
        _GRAPHS[kernel] = (jp, tp)
    return _GRAPHS[kernel]


def compile_both(fault_kw=None, kernel="bfs", **plan_kw):
    jp, tp = graphs(kernel)
    jf = tf = None
    if fault_kw is not None:
        jf, tf = jfaults.FaultSpec(**fault_kw), faults.FaultSpec(**fault_kw)
    return (jax_compile(JaxPlan(layout=(), kernel=kernel, **plan_kw), jp, fault=jf),
            compile_plan(TraversalPlan(layout=(), kernel=kernel, **plan_kw), tp,
                         device="cpu", fault=tf))


def assert_runs_equal(got, want):
    """Every checked-execution field and the (corrupted) rows, bit for bit."""
    g, w = got.run, want.run
    assert g.check_counts == w.check_counts
    assert g.check_failures == w.check_failures
    assert (g.retries, g.fallbacks) == (w.retries, w.fallbacks)
    assert g.quarantined == w.quarantined
    assert g.validated == w.validated
    assert g.edges == [int(m) for m in w.edges]
    assert [t == 0.0 for t in g.teps] == [t == 0.0 for t in w.teps]
    assert (g.harmonic_mean_teps == 0.0) == (w.harmonic_mean_teps == 0.0)
    np.testing.assert_array_equal(got.parent, np.asarray(want.parent))
    np.testing.assert_array_equal(got.level, np.asarray(want.level))


# ---------------------------------------------------------------------------
# FaultSpec, fires and corrupt_parent
# ---------------------------------------------------------------------------

def test_fault_vocabulary_equal_to_jax():
    assert faults.FAULT_SITES == jfaults.FAULT_SITES
    assert faults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert faults.FAULT_CLASSES == jfaults.FAULT_CLASSES
    assert len(faults.FAULT_CLASSES) >= 6


@pytest.mark.parametrize("kw", [
    dict(site="bogus", kind="zero"), dict(site="exchange", kind="stale"),
    dict(site="parent", kind="drop"), dict(site="sieve", kind="zero")])
def test_faultspec_rejects_like_jax(kw):
    with pytest.raises(ValueError) as want:
        jfaults.FaultSpec(**kw)
    with pytest.raises(ValueError) as got:
        faults.FaultSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(site="parent", kind="self", level=2, persistent=True),
    dict(site="parent", kind="offset", level=1, root=7),
    dict(site="exchange", kind="flip", device=3, word=2, bit=5),
    dict(site="codec", kind="payload_flip", seed=3)])
def test_faultspec_describe_and_hash(kw):
    f = faults.FaultSpec(**kw)
    assert f.describe() == jfaults.FaultSpec(**kw).describe()
    assert hash(f) == hash(faults.FaultSpec(**kw)) and f == faults.FaultSpec(**kw)
    with pytest.raises(dataclasses.FrozenInstanceError):
        f.level = 0


@pytest.mark.parametrize("kw,site,level,root", [
    (dict(site="parent", kind="self", level=2), "parent", 2, 0),
    (dict(site="parent", kind="self", level=2), "parent", 3, 0),
    (dict(site="parent", kind="self", level=2, persistent=True), "parent", 3, 0),
    (dict(site="parent", kind="self", level=2, persistent=True), "parent", 1, 0),
    (dict(site="parent", kind="offset", root=5), "parent", 0, 5),
    (dict(site="parent", kind="offset", root=5), "parent", 4, 6),
    (dict(site="parent", kind="offset"), "exchange", 1, 0),
])
def test_fires_equal_to_jax(kw, site, level, root):
    want = jfaults.fires(jfaults.FaultSpec(**kw), site, level=level, root=root)
    got = faults.fires(faults.FaultSpec(**kw), site, level=level, root=root)
    if want is None:
        assert got is None
    else:
        assert got is bool(want)
    assert faults.fires(None, site, level=level) is None


@pytest.mark.parametrize("kind", ["self", "offset"])
@pytest.mark.parametrize("level", [1, 3])
def test_corrupt_parent_equal_to_jax(kind, level):
    rng = np.random.default_rng(level)
    v = 300
    parent = rng.integers(0, v + 1, v).astype(np.int32)
    parent[:5] = v - 1                      # offset wraps these to 0
    newly = rng.random(v) < 0.3
    ids = np.arange(v, dtype=np.int32)
    kw = dict(site="parent", kind=kind, level=3)
    want = jfaults.corrupt_parent(jfaults.FaultSpec(**kw), jnp.asarray(parent),
                                  jnp.asarray(newly), jnp.asarray(ids),
                                  jnp.int32(v), level=level)
    got = faults.corrupt_parent(faults.FaultSpec(**kw), torch.from_numpy(parent),
                                torch.from_numpy(newly), torch.from_numpy(ids), v,
                                level=level)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (level == 3) == (not np.array_equal(got.numpy(), parent))


# ---------------------------------------------------------------------------
# The exchange sites' helpers, on the same arrays as JAX's
# ---------------------------------------------------------------------------

def _words(n=48, seed=0):
    w = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)
    w = w.astype(np.uint32)
    w[::3] = 0
    return w, torch.from_numpy(w.view(np.int32).copy())


EXCHANGE_KW = [
    dict(site="exchange", kind="zero", level=2),
    dict(site="exchange", kind="flip", level=2, word=50, bit=31),
    dict(site="exchange", kind="flip", level=-1, word=3, bit=0, device=1),
    dict(site="exchange", kind="zero", level=1, persistent=True, root=5),
]


@pytest.mark.parametrize("kw", EXCHANGE_KW)
@pytest.mark.parametrize("level,device,root", [(1, 0, 5), (2, 1, 5), (3, 1, 4)])
def test_corrupt_delta_equal_to_jax(kw, level, device, root):
    w, tw = _words()
    want = jfaults.corrupt_delta(jfaults.FaultSpec(**kw), jnp.asarray(w), level=level,
                                 device=device, root=root)
    got = faults.corrupt_delta(faults.FaultSpec(**kw), tw, level=level, device=device,
                               root=root)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    # the caller's words are never written
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), w)


@pytest.mark.parametrize("kw", [
    dict(site="codec", kind="payload_flip", word=70, seed=2**33 + 5),
    dict(site="codec", kind="trunc_count", level=2),
    dict(site="codec", kind="wrong_mode", device=1),
])
@pytest.mark.parametrize("level,device", [(2, 0), (2, 1)])
def test_corrupt_encoded_equal_to_jax(kw, level, device):
    w, tw = _words()
    mode, count = np.int32(1), np.int32(17)
    want = jfaults.corrupt_encoded(jfaults.FaultSpec(**kw), jnp.int32(mode),
                                   jnp.asarray(w.view(np.int32)), jnp.int32(count),
                                   level=level, device=device)
    got = faults.corrupt_encoded(faults.FaultSpec(**kw), torch.tensor(mode), tw,
                                 torch.tensor(count), level=level, device=device)
    assert int(got[0]) == int(want[0]) and int(got[2]) == int(want[2])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("level,device", [(0, 0), (1, 2), (1, 3)])
def test_drop_peers_and_corrupt_known_equal_to_jax(level, device):
    w, tw = _words(seed=1)
    f, ft = _words(seed=2)
    for kw in (dict(site="inter_group", kind="drop", level=1, device=2),
               dict(site="inter_group", kind="drop", persistent=True, level=0)):
        want = jfaults.drop_peers(jfaults.FaultSpec(**kw), jnp.asarray(w), jnp.asarray(f),
                                  level=level, device=device)
        got = faults.drop_peers(faults.FaultSpec(**kw), tw, ft, level=level, device=device)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    kw = dict(site="sieve", kind="stale", level=1)
    want = jfaults.corrupt_known(jfaults.FaultSpec(**kw), jnp.asarray(w), level=level,
                                 device=device)
    got = faults.corrupt_known(faults.FaultSpec(**kw), tw, level=level, device=device)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("kw", [
    dict(site="codec", kind="wrong_mode", level=1, persistent=True),
    dict(site="inter_group", kind="drop", level=1, persistent=True),
    dict(site="sieve", kind="stale", level=1, persistent=True),
])
def test_transport_sites_inert_on_one_device_like_jax(kw):
    # one device has no exchange: the run is the clean one, in both packages
    jc, tc = compile_both(kw, batch_roots=True)
    want = jc.run(ROOTS, check="full", retries=1, fallback=True)
    got = tc.run(ROOTS, check="full", retries=1, fallback=True)
    assert_runs_equal(got, want)
    assert got.run.all_valid and got.run.retries == 0


# ---------------------------------------------------------------------------
# The single-device legs of tests/test_faults.py on both packages
# ---------------------------------------------------------------------------

def test_fault_rejects_legacy_engines():
    _, tp = graphs()
    for engine in ("reference", "legacy"):
        with pytest.raises(ValueError, match="engine='bitmap'"):
            compile_plan(TraversalPlan(engine=engine, batch_roots=False), tp,
                         device="cpu",
                         fault=faults.FaultSpec(site="parent", kind="self"))


@pytest.mark.parametrize("method", ["run", "serve_batch"])
def test_rejects_unknown_check_mode(method):
    _, tc = compile_both(batch_roots=True)
    with pytest.raises(ValueError, match="check must be"):
        getattr(tc, method)(ROOTS[:2], check="bogus")


def test_validate_batch_matches_per_root_validate():
    jc, tc = compile_both(batch_roots=True)
    roots = np.arange(6, dtype=np.int32)
    res = tc.bfs(roots)
    val = validate_batch(tc.graph.ev, res.parent, res.level, roots)
    jres = jc.bfs(roots)
    assert val.ok.shape == (6,)
    for i, r in enumerate(roots):
        single = validate(tc.graph.ev, BFSResult(res.parent[i], res.level[i], None),
                          int(r))
        jsingle = jax_validate(graphs()[0].ev, JaxBFSResult(
            parent=jres.parent[i], level=jres.level[i], stats=None), jnp.int32(int(r)))
        for field in val._fields:
            assert bool(getattr(val, field)[i]) == bool(getattr(single, field)) \
                == bool(getattr(jsingle, field)), (field, i)


# (fault, plan, run keywords): tests/test_faults.py:135 (both runs), :154,
# :169 (both batchings), :181; the per-root plan's fallback; an exchange
# fault, which has no hook on one device
LEGS = {
    "parent_self_quarantined": (
        dict(site="parent", kind="self", level=1, persistent=True),
        dict(batch_roots=True), dict(check="post")),
    "parent_self_retried": (
        dict(site="parent", kind="self", level=1, persistent=True),
        dict(batch_roots=True), dict(check="post", retries=2, fallback=True)),
    "root_scoped_offset": (
        dict(site="parent", kind="offset", level=1, persistent=True, root=2),
        dict(batch_roots=True), dict(check="post")),
    "level_once_full": (
        dict(site="parent", kind="self", level=2),
        dict(batch_roots=True), dict(check="full", retries=1)),
    "clean_full_batched": (None, dict(batch_roots=True), dict(check="full")),
    "clean_full_per_root": (None, dict(batch_roots=False), dict(check="full")),
    "clean_full_recovery_armed": (
        None, dict(batch_roots=True), dict(check="full", retries=2, fallback=True)),
    "check_off": (None, dict(batch_roots=True), dict(check="off")),
    "do_validate_false": (None, dict(batch_roots=True), dict(do_validate=False)),
    "per_root_fallback": (
        dict(site="parent", kind="self", level=1, persistent=True),
        dict(batch_roots=False), dict(check="full", retries=1, fallback=True)),
    "exchange_fault_inert": (
        dict(site="exchange", kind="zero", level=1, persistent=True),
        dict(batch_roots=True), dict(check="full", retries=1, fallback=True)),
}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_checked_run_equal_to_jax(leg):
    fault_kw, plan_kw, run_kw = LEGS[leg]
    jc, tc = compile_both(fault_kw, **plan_kw)
    roots = ROOTS[:2] if leg in ("check_off", "do_validate_false") else ROOTS
    want = jc.run(roots, **run_kw)
    got = tc.run(roots, **run_kw)
    assert_runs_equal(got, want)
    run = got.run
    if leg == "parent_self_quarantined":
        assert run.check_counts["depth"] == 4
        assert all("depth" in n for n in run.check_failures.values())
        assert run.quarantined == [0, 1, 2, 3] and run.harmonic_mean_teps == 0.0
    elif leg == "parent_self_retried":
        # the () batched bitmap plan is the degraded shape: no fallback
        assert (run.retries, run.fallbacks) == (8, 0)
        assert run.quarantined == [0, 1, 2, 3]
    elif leg == "root_scoped_offset":
        assert set(run.check_failures) == {2} and run.quarantined == [2]
        assert run.validated == [True, True, False, True]
        assert run.harmonic_mean_teps > 0.0
    elif leg == "per_root_fallback":
        assert (run.retries, run.fallbacks) == (4, 4)
        assert run.quarantined == [0, 1, 2, 3]
    elif leg == "level_once_full":
        # the roots that reach level 2 are corrupted there, retried once
        assert run.check_failures and run.retries == len(run.check_failures)
        assert run.quarantined == sorted(run.check_failures)
    elif leg in ("check_off", "do_validate_false"):
        assert run.validated == [] and not run.all_valid
        assert run.check_counts == {} and run.check_failures == {}
    else:
        assert run.all_valid and not run.quarantined and run.retries == 0
        assert all(v == 0 for v in run.check_counts.values())
    if fault_kw is not None and fault_kw["site"] == "parent":
        # the corrupted tree differs from the clean one where it fired
        clean = compile_both(**plan_kw)[1].run(roots, check="off")
        assert not np.array_equal(got.parent, clean.parent)
    if leg == "exchange_fault_inert":
        clean = compile_both(**plan_kw)[1].run(roots, check="off")
        np.testing.assert_array_equal(got.parent, clean.parent)


@pytest.mark.parametrize("retries,fallback", [(0, False), (1, True)])
def test_serve_batch_equal_to_jax_under_fault(retries, fallback):
    # one root of a padded batch is corrupted; the other rows stay clean
    fault = dict(site="parent", kind="offset", level=1, persistent=True, root=3)
    jc, tc = compile_both(fault, batch_roots=False)
    roots = np.asarray([1, 3, 5, 1], np.int32)
    want = jc.serve_batch(roots, check="full", retries=retries, fallback=fallback)
    got = tc.serve_batch(roots, check="full", retries=retries, fallback=fallback)
    assert got.counts == want.counts and got.failures == want.failures
    assert set(got.failures) == {1}
    np.testing.assert_array_equal(got.parent, np.asarray(want.parent))
    np.testing.assert_array_equal(got.level, np.asarray(want.level))
    # a one-row sub-batch, as recovery solves it
    one = tc.serve_batch(roots[1:2], check="post")
    assert set(one.failures) == {0}
    np.testing.assert_array_equal(one.parent[0], got.parent[1])


# ---------------------------------------------------------------------------
# SSSP: the parent-offset quarantine of tests/test_sssp.py on one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,check", [("offset", "post"), ("self", "full")])
def test_sssp_parent_fault_quarantined_like_jax(kind, check):
    fault = dict(site="parent", kind=kind, level=1, persistent=True)
    jc, tc = compile_both(fault, kernel="sssp", batch_roots=True)
    want = jc.run(ROOTS, check=check, retries=1, fallback=True)
    got = tc.run(ROOTS, check=check, retries=1, fallback=True)
    assert_runs_equal(got, want)
    run = got.run
    assert run.check_counts["tree_dist"] == 4
    assert run.quarantined == [0, 1, 2, 3] and run.harmonic_mean_teps == 0.0
    assert (run.retries, run.fallbacks) == (4, 0)
    clean = compile_both(kernel="sssp", batch_roots=True)[1].run(ROOTS, check="post")
    assert clean.run.all_valid
    # the distances are untouched: only the parents are corrupted
    np.testing.assert_array_equal(got.level, clean.level)
