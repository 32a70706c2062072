"""The port's phase ranges and counters (``repro_torch.tracing``) in the
bitmap BFS level loop, the SSSP round loop and the graph's build, at scale
10 on the CPU (and at 13, where the core's rows are a part of the graph's
and the loop skips the core step once they are all visited).

Ranges are recorded only under ``torch.profiler``, in the order the loops
run, each phase closed where the next of its depth opens, a BFS level's or
SSSP round's range around its parts; they follow the levels and
directions of ``stats``; an operation issued in a phase has its range among
its CPU parents; a search that raises leaves none open; the SSSP counters
equal what ``stats`` says of the rounds, and the BFS counters what it says
of the bottom-up levels and the core's launches, read back only when the
counters are read; and a search's outputs are the same with the profiler
on and off.
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


def profiled(kernel, key=0):
    """One search under the profiler: (result, the profiler's events, its
    ranges in the order they open (an enclosing range before the ranges it
    holds), the counters it left)."""
    c, roots = compiled(kernel)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = c.bfs(roots[key])
    prefix = f"repro_torch.{kernel.split('-')[0]}."
    events = prof.events()
    ranges = sorted((e for e in events if e.name.startswith(prefix)),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    return res, events, ranges, tracing.counters()


def traced(kernel, key=0):
    """One search under the profiler: (result, its range names in order,
    the counters it left)."""
    res, _, ranges, counts = profiled(kernel, key)
    prefix = f"repro_torch.{kernel.split('-')[0]}."
    return res, [e.name[len(prefix):] for e in ranges], counts


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
            out += ["round", "bucket", "relax", "tally"]
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


#: The phases of each loop that follow one another, and the parts a step's
#: range encloses.
TOP = {"bfs": ("start", "sync", "level.td", "level.bu", "finish"),
       "sssp": ("start", "sync", "round", "finish")}
STEPS = ("level.td", "level.bu", "round")
PARTS = {"bfs": ("core", "relax", "epilogue"), "sssp": ("bucket", "relax", "tally")}


def _short(e, loop):
    return e.name[len(f"repro_torch.{loop}."):]


def _chain(e):
    """The names of ``e`` and its CPU parents, innermost first."""
    out = []
    while e is not None:
        out.append(e.name)
        e = e.cpu_parent
    return out


@pytest.mark.parametrize("kernel", KERNELS + ("bfs-s13",))
@pytest.mark.parametrize("key", [0, 2])
def test_ranges_nest_as_the_loops_run(kernel, key):
    # the top-level phases follow one another, each closed before the next
    # opens; each part lies inside the step opened last before it, which is
    # its CPU parent, and the parts of a step follow one another; ``done``
    # is an empty mark after every range
    _, _, ranges, _ = profiled(kernel, key)
    loop = kernel.split("-")[0]
    top = [e for e in ranges if _short(e, loop) in TOP[loop]]
    parts = [e for e in ranges if _short(e, loop) in PARTS[loop]]
    done = ranges[-1]
    assert _short(done, loop) == "done" and len(top) + len(parts) + 1 == len(ranges)
    assert done.time_range.end - done.time_range.start < top[0].time_range.end - top[0].time_range.start
    for a, b in zip(top, top[1:] + [done]):
        assert a.time_range.start <= a.time_range.end <= b.time_range.start
    steps = [e for e in top if _short(e, loop) in STEPS]
    assert len(steps) == sum(_short(e, loop) in STEPS for e in ranges) > 0
    held = {id(s): [] for s in steps}
    for p in parts:
        step = max((s for s in steps if s.time_range.start <= p.time_range.start),
                   key=lambda s: s.time_range.start)
        assert step.time_range.start <= p.time_range.start
        assert p.time_range.end <= step.time_range.end
        assert _chain(p)[1] == step.name
        held[id(step)].append(p)
    for s in steps:
        ps = held[id(s)]
        assert [_short(p, loop) for p in ps][-2:] == (
            ["relax", "tally"] if loop == "sssp" else ["relax", "epilogue"])
        for a, b in zip(ps, ps[1:]):
            assert a.time_range.end <= b.time_range.start


@pytest.mark.parametrize("kernel", KERNELS)
def test_an_operation_has_its_phase_among_its_parents(kernel):
    # every torch operation of a search lies in a phase (the first traced
    # search also allocates the device's counters before its first), and
    # the innermost range around it in time is in its chain of CPU parents:
    # the bucket's passes over V and the tally's sums each in their own range
    c, roots = compiled(kernel)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        c.bfs(roots[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c.bfs(roots[1])
    loop, events = kernel, prof.events()
    ranges = [e for e in events if e.name.startswith(f"repro_torch.{loop}.")]
    ops = [e for e in events if e.name.startswith("aten::")]
    assert len(ops) > 50
    found: dict = {}
    for op in ops:
        around = [r for r in ranges
                  if r.time_range.start <= op.time_range.start < r.time_range.end]
        assert around, op.name
        inner = max(around, key=lambda r: r.time_range.start)
        assert inner.name in _chain(op), (op.name, inner.name)
        found.setdefault(_short(inner, loop), set()).add(op.name)
    assert {"aten::full", "aten::zeros"} <= found["start"]
    assert "aten::where" in found["finish"]
    if kernel == "sssp":
        assert {"aten::where", "aten::min", "aten::eq"} <= found["bucket"]
        assert "aten::sum" in found["tally"]
        assert "aten::sum" not in found["bucket"] | found["relax"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_no_range_is_a_user_annotation(kernel):
    # a user annotation (record_function) gets a device-side echo; the
    # phase ranges are the fast RecordFunction, which gets none
    from torch.profiler import record_function
    c, roots = compiled(kernel)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.search"):
            c.bfs(roots[0])
    events = prof.events()
    ours = [e for e in events if e.name.startswith("repro_torch.")]
    assert len(ours) > 10 and not any(e.is_user_annotation for e in ours)
    assert all(e.is_user_annotation for e in events if e.name == "portbench.search")


@pytest.mark.parametrize("kernel,site", [("bfs", "bfs_level_delta"), ("bfs", "bfs_live_chunks"),
                                         ("sssp", "sssp_relax")])
def test_a_search_that_raises_leaves_no_range_open(kernel, site, monkeypatch):
    # a kernel of the second step raises: every range the search opened is
    # closed, innermost first, and the next traced search runs as before
    opened, real_rf = [], torch._C._profiler._RecordFunctionFast

    class Spy:
        def __init__(self, name):
            self.name, self.r = name, real_rf(name)

        def __enter__(self):
            opened.append(self.name)
            return self.r.__enter__()

        def __exit__(self, *exc):
            assert opened[-1] == self.name
            opened.pop()
            return self.r.__exit__(*exc)

    real, calls = getattr(kops, site), []

    def fail(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected")
        return real(*a, **kw)

    c, roots = compiled(kernel)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Spy)
    monkeypatch.setattr(kops, site, fail)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="injected"):
            c.bfs(roots[0])
        assert len(calls) == 2 and opened == []
    monkeypatch.setattr(kops, site, real)
    res, marks, _ = traced(kernel)
    assert marks == expected_marks(kernel, res)


@pytest.mark.parametrize("kernel", KERNELS)
def test_counters_are_reduced_when_read_not_in_the_search(kernel):
    # a traced search's prologue and result issue no work for its counters
    # (before: the prologue's zeroed sums; the result's ``cat``, comparison,
    # ``sum`` and readback): the prologue makes only the state's ``zeros``
    # (BFS: the frontier and the level's sums; SSSP: the changed set and two
    # stats rows), the result no ``sum``; the counters' reductions run
    # when they are read, and two searches read what each reads alone
    c, roots = compiled(kernel)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c.bfs(roots[0])            # the first allocates the device's accumulator
        c.bfs(roots[1])
    events = prof.events()
    for name in ("start", "finish"):
        last = max((e for e in events if e.name == f"repro_torch.{kernel}.{name}"),
                   key=lambda e: e.time_range.start)
        under = [e.name for e in events if e.cpu_parent is last]
        if name == "start":
            assert under.count("aten::zeros") == (2 if kernel == "bfs" else 3)
        else:
            assert under and "aten::sum" not in under
            assert kernel == "sssp" or "aten::cat" not in under
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        counts = tracing.counters()
    assert "aten::sum" in {e.name for e in prof.events()}
    _, _, first = traced(kernel, 0)
    _, _, second = traced(kernel, 1)
    assert counts == {k: first[k] + second[k] for k in first}


def test_device_counters_and_held_counts_are_read_once(monkeypatch):
    # a device counter's gains since the last read, and each held count once;
    # past HELD_BYTES the held counts are reduced at once and let go
    tracing.reset()
    a = tracing.device_counter("t.a", "cpu")
    assert tracing.device_counter("t.a", "cpu") is a
    a += 5
    tracing.count_later("t.b", torch.sum, torch.ones(4, dtype=torch.int32))
    assert tracing.counters() == {"t.a": 5, "t.b": 4}
    a += 2
    assert tracing.counters() == {"t.a": 7, "t.b": 4}
    monkeypatch.setattr(tracing, "HELD_BYTES", 200)
    big = torch.ones(32, dtype=torch.int32)          # 128 bytes
    tracing.count_later("t.b", torch.sum, big)
    assert tracing._later[0][2][0] is big
    tracing.count_later("t.b", torch.sum, big)
    assert all(args[0].numel() == 1 for _, _, args in tracing._later)
    assert tracing.counters() == {"t.a": 7, "t.b": 4 + 64}
    tracing.reset()
    assert tracing.counters() == {}


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
