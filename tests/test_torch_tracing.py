"""The port's phase marks and counters (``repro_torch.tracing``) in the
bitmap BFS level loop, the SSSP round loop and the graph's build, at scale
10 on the CPU (and at 13, where the core's rows are a part of the graph's
and the loop skips the core step once they are all visited).

Marks are recorded only under ``torch.profiler``, in the order the loops
run; they follow the levels and directions of ``stats``; the SSSP counters
equal what ``stats`` says of the rounds, and the BFS counters what it says
of the bottom-up levels and the core's launches; and a search's outputs
are the same with the profiler on and off.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core import heavy
from repro_torch.core.hybrid_bfs import BOTTOM_UP
from repro_torch.core.pipeline import Graph500Config, build, search_keys
from repro_torch.core.plan import compile_plan
from repro_torch.kernels import ops as kops, ref

from core_spmv_cases import core_step_runs, core_steps

torch.set_num_threads(2)

KERNELS = ("bfs", "sssp")
_COMPILED: dict = {}


def compiled(kernel):
    """(CompiledBFS, search keys) of the scale-10 graph for ``kernel``:
    the ``pre-g500`` rung (``bfs``: heavy core, bitmap engine; its core,
    K = 4,096, spans every vertex; ``bfs-s13``: the rung at scale 13, whose
    core of 4,096 rows is half the vertices), the bitmap engine without a core
    (``bfs-nocore``), or SSSP (``sssp-real``: the specification's real
    weights)."""
    if kernel not in _COMPILED:
        kw = dict(scale=13 if kernel == "bfs-s13" else 10, seed=3, n_roots=4, device="cpu")
        cfg = (Graph500Config.ladder("pre-g500", **kw) if kernel in ("bfs", "bfs-s13")
               else Graph500Config(heavy_threshold=None, **kw) if kernel == "bfs-nocore"
               else Graph500Config(kernel="sssp", heavy_threshold=None,
                                   real_weights=kernel == "sssp-real", **kw))
        built = build(cfg)
        _COMPILED[kernel] = (compile_plan(cfg.to_plan(), built, device="cpu"),
                             [int(r) for r in search_keys(cfg, built)])
    return _COMPILED[kernel]


def traced(kernel, key=0):
    """One search under the profiler: (result, its mark names in order,
    the counters it left)."""
    c, roots = compiled(kernel)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = c.bfs(roots[key])
    prefix = f"repro_torch.{kernel.split('-')[0]}."
    marks = sorted((e for e in prof.events() if e.name.startswith(prefix)),
                   key=lambda e: e.time_range.start)
    return res, [e.name[len(prefix):] for e in marks], tracing.counters()


def expected_marks(kernel, res):
    """The marks a search with these stats makes, in order."""
    n = int(res.stats.levels)
    core = compiled(kernel)[0].core
    runs = (core_step_runs(res, min(core.k, res.level.shape[0])) if core is not None
            else [False] * n)
    out = ["start"]
    for i in range(n):
        if i:
            out.append("sync")
        if kernel == "sssp":
            out.append("round")
        elif int(res.stats.direction[i]) == BOTTOM_UP:
            out += ["level.bu"] + ["core"] * runs[i] + ["relax", "epilogue"]
        else:
            out += ["level.td", "relax", "epilogue"]
    return out + ["sync", "finish", "done"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_no_profiler_records_no_mark_and_no_count(kernel, monkeypatch):
    calls = []
    real = torch._C._profiler._RecordFunctionFast

    def spy(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", spy)
    c, roots = compiled(kernel)
    tracing.reset()
    c.bfs(roots[1])
    assert calls == []
    assert tracing.counters() == {}
    tracing.mark("repro_torch.test")
    tracing.count("test", 3)
    assert calls == [] and tracing.counters() == {}


@pytest.mark.parametrize("kernel", KERNELS + ("bfs-s13",))
def test_marks_run_in_order_from_start_to_done(kernel):
    res, marks, _ = traced(kernel)
    assert marks[0] == "start" and marks[-1] == "done"
    assert marks == expected_marks(kernel, res)
    if kernel == "bfs-s13":          # a bottom-up level without the core step
        assert marks.count("core") < marks.count("level.bu")


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("key", [0, 2])
def test_level_marks_number_the_levels_in_their_directions(kernel, key):
    res, marks, _ = traced(kernel, key)
    n = int(res.stats.levels)
    if kernel == "sssp":
        assert marks.count("round") == n
        return
    levels = [m for m in marks if m.startswith("level.")]
    assert len(levels) == n
    assert [int(m == "level.bu") for m in levels] == res.stats.direction[:n].tolist()
    assert set(res.stats.direction[:n].tolist()) == {0, 1}   # both directions ran


@pytest.mark.parametrize("key", [0, 1, 2, 3])
def test_compact_marks_exactly_the_top_down_levels(key):
    # no level makes a synchronising mark other than its one ``sync``: the
    # live chunks are counted and the stats written on the device, so
    # neither ``compact`` nor ``stats`` is marked, and each level after the
    # first (and the loop's end) opens with exactly one ``sync``
    res, marks, _ = traced("bfs", key)
    n = int(res.stats.levels)
    assert not {"compact", "stats"} & set(marks)
    opens = [i for i, m in enumerate(marks) if m.startswith("level.")]
    assert len(opens) == n
    assert [marks[i - 1] for i in opens[1:]] == ["sync"] * (n - 1)
    assert marks.count("sync") == n and marks[-3:] == ["sync", "finish", "done"]
    assert set(res.stats.direction[:n].tolist()) == {0, 1}


def sssp_counts(res) -> dict:
    """The SSSP counters a search with this result makes: the entries its
    relax scans (the frontiers' out-edges: it reads their rows and nothing
    else), the frontiers' vertices, and the vertices reached."""
    rounds = int(res.stats.levels)
    return {"sssp.frontier_edges": int(res.stats.scanned_edges[:rounds].long().sum()),
            "sssp.frontier_vertices": int(res.stats.frontier_size[:rounds].long().sum()),
            "sssp.reached_vertices": int((res.level >= 0).sum())}


@pytest.mark.parametrize("key", [0, 1, 2, 3])
def test_sssp_counters_follow_the_rounds(key):
    res, _, counts = traced("sssp", key)
    assert counts == sssp_counts(res)
    assert 0 < counts["sssp.frontier_edges"]
    # every reached vertex enters a frontier, and the root's is reached
    assert counts["sssp.frontier_vertices"] >= counts["sssp.reached_vertices"] > 1


def test_real_weight_counters_appear_only_under_the_profiler():
    c, roots = compiled("sssp-real")
    tracing.reset()
    c.bfs(roots[1])
    assert tracing.counters() == {}
    _, _, counts = traced("sssp-real", 1)
    assert set(counts) == {"sssp.frontier_edges", "sssp.frontier_vertices",
                           "sssp.reached_vertices"}


@pytest.mark.parametrize("key", [0, 1, 2, 3])
def test_sssp_real_counters_follow_the_rounds(key):
    res, marks, counts = traced("sssp-real", key)
    assert marks == expected_marks("sssp", res)
    assert counts == sssp_counts(res)
    assert counts["sssp.frontier_vertices"] >= counts["sssp.reached_vertices"] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sssp", "sssp-real"])
def test_sssp_counters_on_the_card_follow_the_rounds(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    kw = dict(scale=12, seed=3, n_roots=4, device="cuda")
    cfg = Graph500Config(kernel="sssp", heavy_threshold=None,
                         real_weights=kernel == "sssp-real", **kw)
    built = build(cfg)
    c = compile_plan(cfg.to_plan(), built, device="cuda")
    for root in search_keys(cfg, built):
        c.bfs(int(root))                       # built and warm
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            res = c.bfs(int(root))
        assert tracing.counters() == sssp_counts(res)


@pytest.mark.parametrize("graph", ["bfs", "bfs-nocore", "bfs-s13"])
@pytest.mark.parametrize("key", [0, 1, 2, 3])
def test_bfs_counters_follow_the_bottom_up_levels(graph, key):
    # the bottom-up relax reads less than the unvisited adjacency: its walks
    # stop at each row's first frontier neighbour and skip the core's
    # entries, which at scale 10 are every entry when there is a core (K >= V)
    res, _, counts = traced(graph, key)
    n = int(res.stats.levels)
    bu = res.stats.direction[:n] == BOTTOM_UP
    unvisited = int(res.stats.scanned_edges[:n][bu].long().sum())
    core = (set() if graph == "bfs-nocore" else
            {"bfs.core_words_read", "bfs.core_words", "bfs.core_steps",
             "bfs.core_steps_skipped"})
    assert set(counts) == {"bfs.bu_entries_read", "bfs.bu_entries_unvisited"} | core
    assert counts["bfs.bu_entries_unvisited"] == unvisited > 0
    if graph == "bfs":
        assert compiled(graph)[0].core.k >= res.parent.shape[0]
        assert counts["bfs.bu_entries_read"] == 0
    else:
        assert 0 < counts["bfs.bu_entries_read"] < unvisited


@pytest.mark.parametrize("graph", ["bfs", "bfs-s13"])
@pytest.mark.parametrize("key", [0, 1, 2, 3])
def test_core_counters_follow_the_core_launches(graph, key, monkeypatch):
    # one core_spmv launch over the K x W core on each bottom-up level that
    # begins with a core row unvisited (its level -1 or above the level's),
    # each row read up to the group of its first frontier hit (the rule of
    # ref.core_words_read, applied to each launch's output); the other
    # bottom-up levels skip the step.  At scale 10 the core spans every
    # vertex, isolated ones too, so every bottom-up level launches; at 13
    # every key's first bottom-up level launches and a later one skips
    c = compiled(graph)[0]
    outs = []
    real = kops.core_spmv

    def keep(*a, **kw):
        outs.append(real(*a, **kw))
        return outs[-1]

    monkeypatch.setattr(kops, "core_spmv", keep)
    res, _, counts = traced(graph, key)
    n_bu, launched = core_steps(res, min(c.core.k, res.parent.shape[0]))
    words = c.core.a_core.numel()
    assert len(outs) == launched > 0
    assert (launched == n_bu) == (graph == "bfs")
    assert counts["bfs.core_words"] == launched * words
    assert counts["bfs.core_steps"] == n_bu
    assert counts["bfs.core_steps_skipped"] == n_bu - launched
    assert counts["bfs.core_words_read"] == sum(
        int(ref.core_words_read(o, c.core.a_core.shape[1])) for o in outs)
    assert 0 < counts["bfs.core_words_read"] <= counts["bfs.core_words"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_outputs_equal_with_the_profiler_on_and_off(kernel):
    c, roots = compiled(kernel)
    for key in range(len(roots)):
        off = c.bfs(roots[key])
        on, marks, _ = traced(kernel, key)
        assert marks
        assert torch.equal(on.parent, off.parent)
        assert torch.equal(on.level, off.level)
        for f in off.stats._fields:
            a, b = getattr(on.stats, f), getattr(off.stats, f)
            assert (a is None and b is None) or torch.equal(a, b), f


@pytest.mark.parametrize("block_bytes", ["module", 1 << 16])
def test_build_marks_its_phases_and_counts_the_core(block_bytes, monkeypatch):
    # pipeline.build under the profiler: the four build marks in order, and
    # the core's words (K * K/32) and row blocks; without one, no count
    if block_bytes != "module":
        monkeypatch.setattr(heavy, "CORE_BLOCK_BYTES", block_bytes)
    cfg = Graph500Config.ladder("pre-g500", scale=10, seed=3, n_roots=4, device="cpu")
    tracing.reset()
    build(cfg)
    assert not any(k.startswith("build.") for k in tracing.counters())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        built = build(cfg)
    marks = sorted((e for e in prof.events() if e.name.startswith("repro_torch.build.")),
                   key=lambda e: e.time_range.start)
    assert [e.name.rsplit(".", 1)[1] for e in marks] == ["csr", "sort", "core", "done"]
    k = built.core.k
    row_offsets = np.pad(np.cumsum(np.r_[0, built.degree.numpy()])[: k + 1],
                         (0, max(0, k - built.n_vertices)), mode="edge")
    blocks = len(heavy.core_blocks(row_offsets, k, heavy.CORE_BLOCK_BYTES)) - 1
    assert blocks == 1 if block_bytes == "module" else blocks > 100
    assert tracing.counters() == {"build.core_words": k * k // 32, "build.core_blocks": blocks}
