"""The port's SSSP kernel (δ-stepping), its weights, oracle, validation and
kernel registry against the JAX package, bit for bit.

Both packages run on the same numpy inputs: the JAX-built weighted edge
view carried into the port with ``repro_torch.convert``, and the grid and
Erdős–Rényi families, which both draw from numpy's ``default_rng``.
Parents, distances and every stats trace must be identical per root and
batched, and equal to the host Dijkstra oracle of either package.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import build_csr as jax_build_csr
from repro.core import edge_view as jax_edge_view
from repro.core import pipeline as jpipe
from repro.core import kronecker as jkron
from repro.core.bfs_steps import chunk_edge_view as jax_chunk_edge_view
from repro.core.bfs_steps import with_edge_weights as jax_with_edge_weights
from repro.core.graph_build import edge_weights as jax_edge_weights
from repro.core.hybrid_bfs import BFSResult as JaxBFSResult
from repro.core.kernels import rekernel_plan as jax_rekernel_plan
from repro.core.plan import PreparedGraph as JaxPrepared
from repro.core.plan import TraversalPlan as JaxPlan
from repro.core.plan import compile_plan as jax_compile
from repro.core.sssp_steps import bucket_width as jax_bucket_width
from repro.core.sssp_steps import sssp_max_rounds as jax_sssp_max_rounds
from repro.core.sssp_steps import sssp_oracle as jax_sssp_oracle
from repro.core.validate import failure_report as jax_failure_report
from repro.core.validate import validate_sssp as jax_validate_sssp
from repro.core.validate import validate_sssp_batch as jax_validate_sssp_batch
from repro.data import graphs as jgraphs
from repro_torch import convert
from repro_torch.core import bfs_steps, graph_build, kernels, pipeline, sssp_steps
from repro_torch.core.hybrid_bfs import BFSResult
from repro_torch.core.plan import PreparedGraph, TraversalPlan, compile_plan, validate_plan
from repro_torch.core.validate import (
    SSSP_CHECK_NAMES, failure_report, validate_sssp, validate_sssp_batch,
)
from repro_torch.data import graphs

torch.set_num_threads(2)

_GRAPHS: dict = {}


def weighted(family):
    """(JAX prepared graph, port prepared graph, roots), cached: the JAX
    weighted edge view carried into the port."""
    if family not in _GRAPHS:
        if family == "kronecker":
            jb = jpipe.build(jpipe.Graph500Config(scale=10, kernel="sssp", seed=3))
            ev, degree = jb.ev, jb.degree
            roots = np.array([0, 5, 77], np.int32)
        else:
            el = (jgraphs.grid_graph(20, seed=5) if family == "grid"
                  else jgraphs.erdos_renyi_graph(400, avg_degree=6, seed=7))
            g = jax_build_csr(el)
            ev = jax_with_edge_weights(jax_edge_view(g), seed=2)
            degree = g.degree
            roots = np.array([0, 3, 11], np.int32)
        jp = JaxPrepared(ev=ev, degree=degree, core=None, chunks=jax_chunk_edge_view(ev))
        tb = convert.built_from_numpy(
            np.asarray(ev.src), np.asarray(ev.dst), np.asarray(ev.valid),
            np.asarray(degree), num_vertices=ev.num_vertices,
            weight=np.asarray(ev.weight), device="cpu")
        tp = PreparedGraph(ev=tb.ev, degree=tb.degree)
        _GRAPHS[family] = (jp, tp, roots)
    return _GRAPHS[family]


def assert_results_equal(got, want):
    np.testing.assert_array_equal(got.parent.numpy(), np.asarray(want.parent))
    np.testing.assert_array_equal(got.level.numpy(), np.asarray(want.level))
    for f in want.stats._fields:
        np.testing.assert_array_equal(getattr(got.stats, f).numpy(),
                                      np.asarray(getattr(want.stats, f)), err_msg=f)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,max_weight", [
    (0, 255), (1, 1), (2**32 + 5, 255), (2**40 + 3, 1000), (7, 2**32 - 1)])
def test_edge_weights_bit_identical_to_jax(seed, max_weight):
    rng = np.random.default_rng(seed % 1000)
    n = 20000
    src = rng.integers(0, 2**31, n).astype(np.int32)
    dst = rng.integers(0, 2**31, n).astype(np.int32)
    src[:50] = 2**31 - 1 - np.arange(50)            # ids near 2^31
    dst[50:100] = 2**31 - 1
    src[100], dst[100] = 0, 0
    valid = rng.random(n) < 0.9
    want = np.asarray(jax_edge_weights(src, dst, valid, seed=seed,
                                       max_weight=max_weight))
    got = graph_build.edge_weights(torch.from_numpy(src), torch.from_numpy(dst),
                                   torch.from_numpy(valid), seed=seed,
                                   max_weight=max_weight)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # symmetric in the endpoint pair
    back = graph_build.edge_weights(torch.from_numpy(dst), torch.from_numpy(src),
                                    torch.from_numpy(valid), seed=seed,
                                    max_weight=max_weight)
    assert torch.equal(got, back)
    assert int(got[valid].min()) >= 1 and int(got.max()) <= max_weight


def test_edge_weights_reject_max_weight_below_one():
    z = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="max_weight"):
        graph_build.edge_weights(z, z, z.bool(), max_weight=0)


def test_weight_plane_rides_through_chunking():
    jp, tp, _ = weighted("kronecker")
    ev = bfs_steps.with_edge_weights(
        bfs_steps.EdgeView(tp.ev.src, tp.ev.dst, tp.ev.valid, tp.ev.num_vertices),
        seed=3)
    np.testing.assert_array_equal(ev.weight.numpy(), np.asarray(jp.ev.weight))
    chunks = bfs_steps.chunk_edge_view(ev, 7)
    want = jax_chunk_edge_view(jp.ev, 7)
    np.testing.assert_array_equal(chunks.weight.numpy(), np.asarray(want.weight))
    assert bfs_steps.chunk_edge_view(tp.ev.__class__(
        tp.ev.src, tp.ev.dst, tp.ev.valid, tp.ev.num_vertices), 7).weight is None


# ---------------------------------------------------------------------------
# The engine, per root and batched, and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["kronecker", "grid", "erdos_renyi"])
@pytest.mark.parametrize("batch", [False, True])
def test_sssp_bitwise_equal_to_jax(family, batch):
    jp, tp, roots = weighted(family)
    jc = jax_compile(JaxPlan(layout=(), batch_roots=batch, kernel="sssp"), jp)
    tc = compile_plan(TraversalPlan(layout=(), batch_roots=batch, kernel="sssp"), tp,
                      device="cpu")
    assert tc.delta == jax_bucket_width(int(np.asarray(jp.ev.weight).max()))
    assert tc.max_rounds == 512
    if batch:
        got = tc.bfs(roots)
        assert_results_equal(got, jc.bfs(roots))
    else:
        for r in roots:
            got = tc.bfs(int(r))
            assert_results_equal(got, jc.bfs(int(r)))
    if family == "grid":
        # the grid's diameter shows up as a many-round traversal
        assert int(got.stats.levels.max()) > 20


@pytest.mark.parametrize("family", ["kronecker", "grid", "erdos_renyi"])
def test_sssp_matches_both_oracles(family):
    jp, tp, roots = weighted(family)
    ev = tp.ev
    res = compile_plan(TraversalPlan(kernel="sssp"), tp, device="cpu").bfs(roots)
    args = (ev.src.numpy(), ev.dst.numpy(), ev.valid.numpy(), ev.weight.numpy(),
            ev.num_vertices)
    for i, r in enumerate(roots):
        p, d = sssp_steps.sssp_oracle(*args, int(r))
        jp_, jd = jax_sssp_oracle(*args, int(r))
        np.testing.assert_array_equal(p, jp_)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(res.parent[i].numpy(), p)
        np.testing.assert_array_equal(res.level[i].numpy(), d)


def test_round_bound_truncates_like_jax():
    # a path of 2,000 vertices needs a round per hop or so, past the
    # default bound of 512: the port stops where the JAX engine stops, with
    # the same partial planes and traces
    from repro.core.kronecker import EdgeList as JaxEdgeList
    n = 2000
    g = jax_build_csr(JaxEdgeList(src=jnp.arange(n - 1, dtype=jnp.int32),
                                  dst=jnp.arange(1, n, dtype=jnp.int32),
                                  num_vertices=n))
    ev = jax_with_edge_weights(jax_edge_view(g), seed=2)
    jpg = JaxPrepared(ev=ev, degree=g.degree, core=None, chunks=jax_chunk_edge_view(ev))
    tb = convert.built_from_numpy(
        np.asarray(ev.src), np.asarray(ev.dst), np.asarray(ev.valid),
        np.asarray(g.degree), num_vertices=n, weight=np.asarray(ev.weight),
        device="cpu")
    jc = jax_compile(JaxPlan(batch_roots=False, kernel="sssp"), jpg)
    tc = compile_plan(TraversalPlan(batch_roots=False, kernel="sssp"),
                      PreparedGraph(ev=tb.ev, degree=tb.degree), device="cpu")
    got = tc.bfs(0)
    assert_results_equal(got, jc.bfs(0))
    assert int(got.stats.levels) == 512   # the default bound, reached
    assert int((got.level < 0).sum()) > 0


def test_port_graph_families_equal_jax():
    for ours, theirs in ((graphs.grid_graph(9, seed=3, device="cpu"),
                          jgraphs.grid_graph(9, seed=3)),
                         (graphs.erdos_renyi_graph(100, avg_degree=5, seed=9,
                                                   device="cpu"),
                          jgraphs.erdos_renyi_graph(100, avg_degree=5, seed=9))):
        assert ours.num_vertices == theirs.num_vertices
        np.testing.assert_array_equal(ours.src.numpy(), np.asarray(theirs.src))
        np.testing.assert_array_equal(ours.dst.numpy(), np.asarray(theirs.dst))
        assert ours.src.dtype == torch.int32


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

def _corruptions(ev, root, parent, dist):
    """(name, parent, dist) rows: clean plus deliberately broken trees."""
    v = ev.num_vertices
    src, dst = np.asarray(ev.src), np.asarray(ev.dst)
    reached = np.nonzero((parent >= 0) & (np.arange(v) != root))[0]
    far = reached[np.argmax(dist[reached])]
    rows = [("clean", parent, dist)]

    def mut(name, *changes):
        p, d = parent.copy(), dist.copy()
        for arr, idx, val in changes:
            (p if arr == "p" else d)[idx] = val
        rows.append((name, p, d))

    # the parent flipped to another reached neighbour
    reached_set = set(reached.tolist()) | {root}
    flips = ((int(x), int(u)) for x in reached[np.argsort(-dist[reached])]
             for u in dst[src == x] if int(u) in reached_set
             and int(u) != int(parent[x]))
    x, u = next(flips)
    mut("flipped_parent", ("p", x, u))
    nbrs = set(dst[src == far].tolist())
    mut("dist_plus_one", ("d", far, dist[far] + 1))
    mut("root_dist", ("d", root, 3))
    # a reached vertex beside an unreached one: drop a leaf from the tree
    leaf = next(int(u) for u in reached[::-1] if int(u) not in set(parent.tolist()))
    mut("dropped_leaf", ("p", leaf, -1), ("d", leaf, -1))
    mut("parent_out_of_range", ("p", far, v + 5))
    mut("non_edge_parent", ("p", far, int(next(u for u in reached if int(u) not in nbrs
                                               and int(u) != far))))
    isolated = np.nonzero(np.bincount(src[np.asarray(ev.valid)], minlength=v) == 0)[0]
    if len(isolated):
        # no edge entries: the empty segment reads as witnessed with weight
        # INT32_MIN, in both packages
        mut("isolated_adopted", ("p", int(isolated[0]), root),
            ("d", int(isolated[0]), 5))
    return rows


@pytest.mark.parametrize("family", ["kronecker", "erdos_renyi"])
def test_validate_sssp_checks_match_jax(family):
    jp, tp, roots = weighted(family)
    root = int(roots[0])
    res = jax_compile(JaxPlan(batch_roots=False, kernel="sssp"), jp).bfs(root)
    rows = _corruptions(jp.ev, root, np.array(res.parent), np.array(res.level))
    assert len(rows) >= 7
    failing = set()
    for name, p, d in rows:
        want = jax_validate_sssp(jp.ev, JaxBFSResult(jnp.asarray(p), jnp.asarray(d), None),
                                 jnp.int32(root))
        got = validate_sssp(tp.ev, BFSResult(torch.from_numpy(p), torch.from_numpy(d),
                                             None), root)
        assert [bool(x) for x in got] == [bool(x) for x in want], name
        if not bool(got.ok):
            failing.update(f for f, x in zip(got._fields[1:], list(got)[1:]) if not bool(x))
    assert bool(validate_sssp(tp.ev, BFSResult(torch.from_numpy(rows[0][1]),
                                               torch.from_numpy(rows[0][2]), None),
                              root).ok)
    # the corruptions reach every check
    assert failing == {f"{n}_ok" for n in SSSP_CHECK_NAMES}
    ps = np.stack([p for _, p, _ in rows])
    ds = np.stack([d for _, _, d in rows])
    rs = np.full(len(rows), root, np.int32)
    got_b = validate_sssp_batch(tp.ev, torch.from_numpy(ps), torch.from_numpy(ds), rs)
    want_b = jax_validate_sssp_batch(jp.ev, jnp.asarray(ps), jnp.asarray(ds), rs)
    assert failure_report(got_b) == jax_failure_report(want_b)


@pytest.mark.parametrize("check", ["off", "post", "full"])
@pytest.mark.parametrize("batch", [False, True])
def test_compiled_sssp_run_matches_jax(check, batch):
    jp, tp, roots = weighted("kronecker")
    jr = jax_compile(JaxPlan(batch_roots=batch, kernel="sssp"), jp).run(roots, check=check)
    tr = compile_plan(TraversalPlan(batch_roots=batch, kernel="sssp"), tp,
                      device="cpu").run(roots, check=check)
    np.testing.assert_array_equal(tr.parent, np.asarray(jr.parent))
    np.testing.assert_array_equal(tr.level, np.asarray(jr.level))
    assert tr.run.edges == jr.run.edges
    assert tr.run.check_counts == jr.run.check_counts
    assert tr.run.validated == jr.run.validated
    assert tr.run.all_valid == (check != "off")
    if check == "full":
        assert set(tr.run.check_counts) == set(SSSP_CHECK_NAMES) | {"sentinel"}


@pytest.mark.parametrize("batched", [False, True])
def test_pipeline_sssp_matches_jax(batched):
    kw = dict(scale=9, n_roots=2, kernel="sssp", max_weight=63, batched=batched)
    jcfg = jpipe.Graph500Config(**kw)
    jbuilt, jrun = jpipe.run(jcfg)
    edges = jkron.generate_edges(jcfg.seed, jcfg.scale, jcfg.edge_factor)
    roots = np.asarray(jkron.sample_roots(jcfg.seed, edges, jcfg.n_roots))
    cfg = pipeline.Graph500Config(device="cpu", **kw)
    assert cfg.to_plan().to_dict() == jcfg.to_plan().to_dict()
    built = pipeline.build(cfg, edges=convert.edge_list_from_numpy(
        np.asarray(edges.src), np.asarray(edges.dst), edges.num_vertices, "cpu"))
    np.testing.assert_array_equal(built.ev.weight.numpy(),
                                  np.asarray(jbuilt.ev.weight).astype(np.int64))
    built, run = pipeline.run(cfg, built, roots=roots)
    assert run.edges == jrun.edges
    assert run.all_valid and jrun.all_valid
    assert run.check_counts == jrun.check_counts
    keys = pipeline.search_keys(cfg, built, roots)
    tres = compile_plan(cfg.to_plan(), built, device="cpu").run(keys)
    jres = jax_compile(jcfg.to_plan(), jbuilt).run(keys)
    np.testing.assert_array_equal(tres.parent, np.asarray(jres.parent))
    np.testing.assert_array_equal(tres.level, np.asarray(jres.level))


# ---------------------------------------------------------------------------
# Plan layer: the kernel axis
# ---------------------------------------------------------------------------

def test_bucket_width_and_round_bound_match_jax():
    for maxw in (0, 1, 2, 3, 255, 256, 2**32 - 1):
        assert sssp_steps.bucket_width(maxw) == jax_bucket_width(maxw)
    for ml in (1, 64, 512, 513, 4096):
        assert sssp_steps.sssp_max_rounds(ml) == jax_sssp_max_rounds(ml)


def test_plan_kernel_axis_validation_and_rekernel():
    with pytest.raises(ValueError, match="unknown kernel"):
        validate_plan(TraversalPlan(kernel="apsp"))
    with pytest.raises(ValueError, match="unknown engine"):
        validate_plan(TraversalPlan(engine="reference", kernel="sssp"))
    with pytest.raises(ValueError, match="unknown exchange"):
        validate_plan(TraversalPlan(layout=("group", "member"),
                                    exchange="hier_or_sieve", kernel="sssp"))
    p = TraversalPlan(layout=("group", "member"), kernel="sssp")
    assert p.exchange == "hier_min"
    d = TraversalPlan(layout=(), batch_roots=True).to_dict()
    del d["kernel"]
    assert TraversalPlan.from_dict(d).kernel == "bfs"
    tuned = TraversalPlan(layout=("group", "member"), mesh_shape=(2, 2),
                          exchange="hier_or_packed", partition="word_cyclic")
    rp = kernels.rekernel_plan(tuned, "sssp")
    assert (rp.kernel, rp.exchange, rp.partition) == \
        ("sssp", "hier_min", "word_cyclic")
    assert kernels.rekernel_plan(rp, "sssp") is rp
    assert rp.to_dict() == jax_rekernel_plan(
        JaxPlan.from_dict(tuned.to_dict()), "sssp").to_dict()
    # a min-family exchange is no OR exchange: back on BFS it takes the
    # BFS default; "flat" belongs to both families and stays
    back = kernels.rekernel_plan(rp, "bfs")
    assert (back.kernel, back.exchange) == ("bfs", "hier_or")
    assert kernels.rekernel_plan(TraversalPlan(kernel="sssp", exchange="flat"),
                                 "bfs").exchange == "flat"
    with pytest.raises(ValueError, match="unknown kernel"):
        kernels.kernel_spec("apsp")
    assert kernels.kernel_spec("sssp").needs_weights
    assert kernels.kernel_spec("bfs").check_names[0] == "root"


def test_sssp_requires_weight_plane():
    _, tp, _ = weighted("erdos_renyi")
    pg = PreparedGraph(ev=bfs_steps.EdgeView(tp.ev.src, tp.ev.dst, tp.ev.valid,
                                             tp.ev.num_vertices), degree=tp.degree)
    with pytest.raises(ValueError, match="weight"):
        compile_plan(TraversalPlan(kernel="sssp"), pg, device="cpu")


def test_sssp_unported_options_still_raise():
    _, tp, roots = weighted("erdos_renyi")
    # the mesh layouts are ported: on one device the 1-shard meshes give the
    # single-device rows, and a mesh too large is JAX's ValueError
    base = compile_plan(TraversalPlan(kernel="sssp"), tp, device="cpu").bfs(roots)
    for layout in (("group", "member"), ("root",)):
        res = compile_plan(TraversalPlan(kernel="sssp", layout=layout), tp,
                           device="cpu").bfs(roots)
        v = base.parent.shape[-1]
        assert torch.equal(res.parent[:, :v], base.parent)
        assert torch.equal(res.level[:, :v], base.level)
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        compile_plan(TraversalPlan(kernel="sssp", layout=("group", "member"),
                                   mesh_shape=(2, 2)), tp, device="cpu")
    # checked execution is ported for SSSP too (tests/test_torch_faults.py)
    c = compile_plan(TraversalPlan(kernel="sssp"), tp, device="cpu")
    run = c.run(roots, retries=1, fallback=True).run
    assert run.all_valid and (run.retries, run.fallbacks, run.quarantined) == (0, 0, [])


# ---------------------------------------------------------------------------
# The sharded engine on virtual CPU meshes, against JAX's single-device rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partition", ["block", "word_cyclic"])
@pytest.mark.parametrize("exchange", ["hier_min", "flat"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_sharded_sssp_equal_to_jax_single_device(shape, exchange, partition):
    from repro_torch.comms.mesh import make_mesh
    jp, tp, roots = weighted("kronecker")
    want = jax_compile(JaxPlan(kernel="sssp"), jp).bfs(roots[:2])
    c = compile_plan(TraversalPlan(kernel="sssp", layout=("group", "member"),
                                   exchange=exchange, partition=partition), tp,
                     device="cpu", mesh=make_mesh(shape, ("group", "member"),
                                                  device="cpu", virtual=True))
    got = c.bfs(roots[:2])
    v = tp.ev.num_vertices
    np.testing.assert_array_equal(got.parent[:, :v].numpy(), np.asarray(want.parent))
    np.testing.assert_array_equal(got.level[:, :v].numpy(), np.asarray(want.level))
    np.testing.assert_array_equal(got.levels.numpy(), np.asarray(want.stats.levels))
    sent = got.sentinel.numpy()
    assert np.all((sent == -1) | (sent == 7))
    run = c.run(roots[:2], check="full")
    assert run.run.all_valid and run.mesh_axes == {"group": shape[0], "member": shape[1]}
