"""The port's multi-device layouts against the JAX package, bit for bit.

Two references:

  * the JAX package's single-device engine, in this process: JAX's own
    tests pin its sharded parents and levels to it, so the port's sharded
    runs on virtual CPU meshes (every shard on the CPU, run in lockstep)
    must equal it: (group, member) shapes x both partitions x the five
    exchanges, the root layouts with padded root counts, the composed
    layout and a word count the shards do not divide;
  * the JAX package's sharded engine on 8 forced host devices, for what has
    no single-device counterpart: the whole ``ShardedRun`` with its sentinel
    traces, the four transport fault sites (corrupted parents, sentinels,
    check counts, retry -> fallback -> quarantine), ``modeled_wire_bytes``
    and ``shard_edge_skew``.  One JAX subprocess computes every such
    reference once for the module (``jax_ref``).
"""
import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import build_csr as jax_build_csr
from repro.core import build_heavy_core as jax_build_heavy_core
from repro.core import degree_reorder as jax_degree_reorder
from repro.core import edge_view as jax_edge_view
from repro.core import generate_edges as jax_generate_edges
from repro.core import pipeline as jpipe
from repro.core import kronecker as jkron
from repro.core.plan import BFSPlan as JaxPlan
from repro.core.plan import compile_plan as jax_compile
from repro.core.reorder import relabel_edges as jax_relabel_edges
from repro.util import respawn_with_host_devices
from repro_torch import convert
from repro_torch.comms.mesh import make_mesh
from repro_torch.core import faults, pipeline
from repro_torch.core.distributed_bfs import (
    modeled_wire_bytes, shard_edge_skew, shard_graph,
)
from repro_torch.core.hybrid_bfs import SENTINEL_OK, SHARD_EXCHANGES
from repro_torch.core.plan import BFSPlan, PreparedGraph, ShardedRun, compile_plan

torch.set_num_threads(2)

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
VERTEX = ("group", "member")
_CACHE: dict = {}


def oracle_graph():
    """(JAX built graph, port built graph, roots, JAX single-device batch)
    at scale 10, core threshold 8, cached."""
    if "oracle" not in _CACHE:
        cfg = jpipe.Graph500Config(scale=10, heavy_threshold=8)
        jb = jpipe.build(cfg)
        edges = jkron.generate_edges(cfg.seed, 10, 16)
        roots = np.asarray(jb.reorder.new_from_old[
            jkron.sample_roots(cfg.seed, edges, 5)])
        tb = convert.built_from_numpy(
            np.asarray(jb.ev.src), np.asarray(jb.ev.dst), np.asarray(jb.ev.valid),
            np.asarray(jb.degree), num_vertices=jb.n_vertices,
            a_core=np.asarray(jb.core.a_core), k_heavy=int(jb.core.k_heavy),
            threshold=8, device="cpu")
        want = jax_compile(JaxPlan(), jb).bfs(roots)
        _CACHE["oracle"] = (jb, tb, roots, want)
    return _CACHE["oracle"]


def virtual(shape, names=VERTEX):
    return make_mesh(shape, names, device="cpu", virtual=True)


def assert_rows_equal(res, want, v, n=None):
    n = len(want.parent) if n is None else n
    np.testing.assert_array_equal(res.parent[:n, :v].numpy(), np.asarray(want.parent)[:n])
    np.testing.assert_array_equal(res.level[:n, :v].numpy(), np.asarray(want.level)[:n])


# ---------------------------------------------------------------------------
# Against the JAX single-device oracle, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exchange", SHARD_EXCHANGES)
@pytest.mark.parametrize("partition", ["block", "word_cyclic"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2), (4, 2)])
def test_vertex_sharded_equal_to_jax_single_device(shape, partition, exchange):
    jb, tb, roots, want = oracle_graph()
    c = compile_plan(BFSPlan(layout=VERTEX, partition=partition, exchange=exchange),
                     tb, device="cpu", mesh=virtual(shape))
    res = c.bfs(roots[:2])
    assert isinstance(res, ShardedRun)
    assert_rows_equal(res, want, jb.n_vertices, 2)
    np.testing.assert_array_equal(res.levels.numpy(), np.asarray(want.stats.levels)[:2])
    sent = res.sentinel.numpy()
    assert np.all((sent == -1) | (sent == SENTINEL_OK))
    # the padded tail stays unvisited
    assert np.all(res.parent[:, jb.n_vertices:].numpy() == -1)


@pytest.mark.parametrize("shape", [(4,), (8,)])
def test_root_layout_pads_and_equals_single_device(shape):
    jb, tb, roots, want = oracle_graph()
    assert len(roots) % shape[0]      # the padding path
    c = compile_plan(BFSPlan(layout=("root",)), tb, device="cpu",
                     mesh=virtual(shape, ("root",)))
    res = c.bfs(roots)
    assert_rows_equal(res, want, jb.n_vertices)
    for got, w in zip(res.stats, want.stats):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    assert c.mesh_axes == {"root": shape[0]}


def test_composed_layout_equal_to_single_device():
    jb, tb, roots, want = oracle_graph()
    c = compile_plan(BFSPlan(layout=("root",) + VERTEX, partition="word_cyclic"), tb,
                     device="cpu", mesh=virtual((2, 2, 2), ("root",) + VERTEX))
    res = c.bfs(roots[:3])          # three roots over two lanes: padded
    assert_rows_equal(res, want, jb.n_vertices, 3)
    run = c.run(roots[:3], check="full")
    assert run.run.all_valid and run.mesh_axes == {"root": 2, "group": 2, "member": 2}
    np.testing.assert_array_equal(run.parent, np.asarray(want.parent)[:3])


def test_vertex_sharded_nonmultiple_word_count():
    # 3 and 5 shards over a 1024-word bitmap: the padded tail (non-pow2
    # members come in through a caller's mesh=, as in JAX)
    jb, tb, roots, want = oracle_graph()
    v = jb.n_vertices
    for shape in ((3, 1), (1, 5)):
        p = shape[0] * shape[1]
        for part in ("block", "word_cyclic"):
            sg = shard_graph(tb.ev.src, tb.ev.dst, tb.ev.valid, v, p, partition=part,
                             device="cpu")
            assert (v // 32) % p and sg.num_vertices > v
            c = compile_plan(BFSPlan(layout=VERTEX, partition=part, batch_roots=False),
                             PreparedGraph(core=tb.core, sharded=sg, degree=tb.degree),
                             device="cpu", mesh=virtual(shape))
            res = c.bfs(int(roots[0]))
            np.testing.assert_array_equal(res.parent[:v].numpy(), np.asarray(want.parent)[0])
            np.testing.assert_array_equal(res.level[:v].numpy(), np.asarray(want.level)[0])
            assert np.all(res.parent[v:].numpy() == -1)


def test_mesh_run_harness_and_rungs():
    jb, tb, roots, want = oracle_graph()
    c = compile_plan(BFSPlan(layout=VERTEX, batch_roots=False), tb, device="cpu",
                     mesh=virtual((2, 2)))
    run = c.run(roots[:2], check="full")
    assert run.run.all_valid and not run.run.batched
    assert run.parent.shape == (2, jb.n_vertices)
    np.testing.assert_array_equal(run.parent, np.asarray(want.parent)[:2])
    # pipeline.run with a mesh, and the two mesh rungs on one device
    cfg = pipeline.Graph500Config.ladder("pre-g500-batch", scale=9, n_roots=2,
                                         device="cpu", layout=VERTEX)
    _, r = pipeline.run(cfg, mesh=virtual((2, 2)))
    assert r.all_valid
    for rung in ("pre-g500-mesh", "pre-g500-mesh3"):
        _, r = pipeline.run(pipeline.Graph500Config.ladder(rung, scale=9, n_roots=2,
                                                           device="cpu"))
        assert r.all_valid and r.batched
    # build(mesh=) partitions the graph for the mesh's vertex shards
    built = pipeline.build(pipeline.Graph500Config(scale=9, device="cpu",
                                                   partition="word_cyclic"),
                           mesh=virtual((2, 2)))
    assert built.sharded.n_devices == 4 and built.sharded.partition == "word_cyclic"


def test_mesh_plans_raise_like_jax():
    jb, tb, roots, _ = oracle_graph()
    with pytest.raises(ValueError, match="do not cover the plan layout"):
        compile_plan(BFSPlan(layout=VERTEX), tb, device="cpu",
                     mesh=virtual((2,), ("root",)))
    with pytest.raises(ValueError, match="do not match plan.mesh_shape"):
        compile_plan(BFSPlan(layout=VERTEX, mesh_shape=(2, 2)), tb, device="cpu",
                     mesh=virtual((4, 1)))
    with pytest.raises(ValueError, match="single device"):
        compile_plan(BFSPlan(), tb, device="cpu", mesh=virtual((1, 1)))
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        compile_plan(BFSPlan(layout=VERTEX, mesh_shape=(4, 2)), tb, device="cpu")
    sg = shard_graph(tb.ev.src, tb.ev.dst, tb.ev.valid, jb.n_vertices, 2, device="cpu")
    with pytest.raises(ValueError, match="partitioned for 2 devices"):
        compile_plan(BFSPlan(layout=VERTEX), PreparedGraph(sharded=sg), device="cpu",
                     mesh=virtual((2, 2)))
    with pytest.raises(ValueError, match="partition='block'"):
        compile_plan(BFSPlan(layout=VERTEX, partition="word_cyclic"),
                     PreparedGraph(sharded=sg), device="cpu", mesh=virtual((2, 1)))
    with pytest.raises(ValueError, match="weighted ShardedGraph"):
        compile_plan(BFSPlan(layout=VERTEX, kernel="sssp"), PreparedGraph(sharded=sg),
                     device="cpu", mesh=virtual((2, 1)))


# ---------------------------------------------------------------------------
# Against JAX's sharded engine (8 forced host devices, one subprocess)
# ---------------------------------------------------------------------------

ROOTS = [0, 1, 2]

#: name -> (mesh shape, partition, exchange, FaultSpec fields or None)
CASES = {
    "clean_2x2_block": ((2, 2), "block", "hier_or", None),
    "clean_2x2_cyclic_packed": ((2, 2), "word_cyclic", "hier_or_packed", None),
    "clean_4x2_cyclic_sieve": ((4, 2), "word_cyclic", "hier_or_sieve", None),
    "clean_2x2_gather": ((2, 2), "block", "hier_gather", None),
    "exchange_zero": ((2, 2), "block", "hier_or",
                      dict(site="exchange", kind="zero", level=1, persistent=True)),
    "exchange_flip_dev2": ((2, 2), "word_cyclic", "flat",
                           dict(site="exchange", kind="flip", level=1, device=2,
                                word=3, bit=31)),
    "codec_payload_flip": ((2, 2), "word_cyclic", "hier_or_packed",
                           dict(site="codec", kind="payload_flip", level=1, device=0,
                                word=2, seed=7)),
    "codec_trunc_count": ((2, 2), "word_cyclic", "hier_or_packed",
                          dict(site="codec", kind="trunc_count", level=2)),
    "codec_wrong_mode": ((2, 2), "block", "hier_or_sieve",
                         dict(site="codec", kind="wrong_mode", level=1, device=0)),
    "inter_group_drop": ((2, 2), "word_cyclic", "hier_or",
                         dict(site="inter_group", kind="drop", level=1, persistent=True)),
    "sieve_stale": ((4, 2), "word_cyclic", "hier_or_sieve",
                    dict(site="sieve", kind="stale", level=2)),
    "parent_offset_root": ((2, 2), "word_cyclic", "hier_or",
                           dict(site="parent", kind="offset", level=1, device=3, root=1)),
}

JAX_SCRIPT = """
import json, sys
import numpy as np
from repro.core import (BFSPlan, PreparedGraph, build_csr, build_heavy_core,
                        compile_plan, degree_reorder, edge_view, generate_edges)
from repro.core.distributed_bfs import modeled_wire_bytes, shard_edge_skew, shard_graph
from repro.core.faults import FaultSpec
from repro.core.reorder import relabel_edges
from repro.util import make_mesh

cases, roots, out = json.loads(sys.argv[1]), np.asarray(json.loads(sys.argv[2]), np.int32), sys.argv[3]
edges = generate_edges(11, 9)
g = build_csr(relabel_edges(edges, degree_reorder(build_csr(edges).degree)))
ev = edge_view(g)
pg = PreparedGraph(ev=ev, degree=g.degree, core=build_heavy_core(g, threshold=32))
arrays, meta = {}, {}

def put(name, res):
    for f in ("parent", "level", "levels", "sentinel"):
        arrays[name + "." + f] = np.asarray(getattr(res, f))

for name, (shape, part, ex, fkw) in cases.items():
    c = compile_plan(BFSPlan(layout=("group", "member"), partition=part, exchange=ex),
                     pg, mesh=make_mesh(tuple(shape), ("group", "member")),
                     fault=None if fkw is None else FaultSpec(**fkw))
    put(name, c.bfs(roots))
    if fkw is not None:
        r = c.run(roots, check="full", retries=1, fallback=True)
        arrays[name + ".run_parent"] = r.parent
        arrays[name + ".run_level"] = r.level
        meta[name] = dict(check_counts=r.run.check_counts,
                          check_failures={str(k): v for k, v in r.run.check_failures.items()},
                          retries=r.run.retries, fallbacks=r.run.fallbacks,
                          quarantined=r.run.quarantined, validated=r.run.validated,
                          edges=[int(e) for e in r.run.edges])
c = compile_plan(BFSPlan(layout=("root", "group", "member")), pg,
                 mesh=make_mesh((2, 2, 2), ("root", "group", "member")))
put("composed", c.bfs(roots))
level_row = arrays["clean_2x2_block.level"][0][:ev.num_vertices]
src, dst, valid = (np.asarray(t) for t in (ev.src, ev.dst, ev.valid))
for part in ("block", "word_cyclic"):
    for gm in ((2, 2), (4, 2), (1, 8)):
        p = gm[0] * gm[1]
        sg = shard_graph(src, dst, valid, ev.num_vertices, p, partition=part)
        key = part + "_" + str(gm[0]) + "x" + str(gm[1])
        meta["skew_" + key] = shard_edge_skew(sg)
        meta["wire_" + key] = modeled_wire_bytes(
            np.concatenate([level_row, -np.ones(sg.num_vertices - ev.num_vertices, np.int32)]),
            n_devices=p, w_loc=sg.w_loc, group=gm[0], member=gm[1], partition=part)
np.savez(out + ".npz", **arrays)
json.dump(meta, open(out + ".json", "w"))
print("OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """Every reference this file needs from JAX's sharded engine, from one
    subprocess with 8 forced host devices."""
    out = str(tmp_path_factory.mktemp("jax_sharded") / "ref")
    proc = respawn_with_host_devices(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), json.dumps(CASES),
         json.dumps(ROOTS), out], 8,
        extra_env={"JAX_PLATFORMS": "cpu"}, pythonpath=(REPO_SRC,), capture=True,
        timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    arrays = dict(np.load(out + ".npz"))
    with open(out + ".json") as f:
        meta = json.load(f)
    return arrays, meta


def fault_graph():
    """The JAX subprocess's graph (scale 9, seed 11, core threshold 32) in
    the port, cached."""
    if "fault" not in _CACHE:
        edges = jax_generate_edges(11, 9)
        g0 = jax_build_csr(edges)
        g = jax_build_csr(jax_relabel_edges(edges, jax_degree_reorder(g0.degree)))
        ev = jax_edge_view(g)
        core = jax_build_heavy_core(g, threshold=32)
        tb = convert.built_from_numpy(
            np.asarray(ev.src), np.asarray(ev.dst), np.asarray(ev.valid),
            np.asarray(g.degree), num_vertices=ev.num_vertices,
            a_core=np.asarray(core.a_core), k_heavy=int(core.k_heavy), threshold=32,
            device="cpu")
        _CACHE["fault"] = PreparedGraph(ev=tb.ev, degree=tb.degree, core=tb.core)
    return _CACHE["fault"]


def assert_sharded_run_equal(res, arrays, name):
    for f in ("parent", "level", "levels", "sentinel"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), arrays[f"{name}.{f}"],
                                      err_msg=f"{name}.{f}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_run_and_faults_equal_to_jax_sharded(jax_ref, name):
    arrays, meta = jax_ref
    shape, part, ex, fkw = CASES[name]
    fault = None if fkw is None else faults.FaultSpec(**fkw)
    c = compile_plan(BFSPlan(layout=VERTEX, partition=part, exchange=ex), fault_graph(),
                     device="cpu", mesh=virtual(shape), fault=fault)
    res = c.bfs(np.asarray(ROOTS))
    assert_sharded_run_equal(res, arrays, name)
    sent = res.sentinel.numpy()
    if fault is None:
        assert np.all((sent == -1) | (sent == SENTINEL_OK))
        return
    run = c.run(np.asarray(ROOTS), check="full", retries=1, fallback=True)
    want = meta[name]
    g = run.run
    assert g.check_counts == want["check_counts"]
    assert {str(k): v for k, v in g.check_failures.items()} == want["check_failures"]
    assert (g.retries, g.fallbacks) == (want["retries"], want["fallbacks"])
    assert g.quarantined == want["quarantined"] and g.validated == want["validated"]
    assert g.edges == want["edges"]
    np.testing.assert_array_equal(run.parent, arrays[f"{name}.run_parent"])
    np.testing.assert_array_equal(run.level, arrays[f"{name}.run_level"])
    if fkw["site"] == "parent":
        # the fallback keeps the parent hook: the one root it fires on stays
        assert g.quarantined == [1] and set(g.check_failures) == {1}
    else:
        # a transport fault is detected, retried (the fault is deterministic,
        # so it fails again) and answered by the single-device fallback,
        # which has no exchange to corrupt
        assert g.check_failures and not g.quarantined
        assert g.retries == g.fallbacks == len(g.check_failures)


def test_composed_sharded_run_equal_to_jax(jax_ref):
    arrays, _ = jax_ref
    c = compile_plan(BFSPlan(layout=("root",) + VERTEX), fault_graph(), device="cpu",
                     mesh=virtual((2, 2, 2), ("root",) + VERTEX))
    assert_sharded_run_equal(c.bfs(np.asarray(ROOTS)), arrays, "composed")


@pytest.mark.parametrize("partition", ["block", "word_cyclic"])
@pytest.mark.parametrize("gm", [(2, 2), (4, 2), (1, 8)])
def test_wire_bytes_and_skew_equal_to_jax(jax_ref, gm, partition):
    arrays, meta = jax_ref
    pg = fault_graph()
    p = gm[0] * gm[1]
    v = pg.ev.num_vertices
    sg = shard_graph(pg.ev.src, pg.ev.dst, pg.ev.valid, v, p, partition=partition,
                     device="cpu")
    key = f"{partition}_{gm[0]}x{gm[1]}"
    assert shard_edge_skew(sg) == meta["skew_" + key]
    level = np.concatenate([arrays["clean_2x2_block.level"][0][:v],
                            -np.ones(sg.num_vertices - v, np.int32)])
    got = modeled_wire_bytes(level, n_devices=p, w_loc=sg.w_loc, group=gm[0],
                             member=gm[1], partition=partition)
    assert json.loads(json.dumps(got)) == meta["wire_" + key]
