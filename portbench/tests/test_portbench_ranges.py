"""The program's phase ranges (``portbench/bench/ranges.py``) and the three
readers of them, on hand-made traces and on a CPU profile of the program:
the runtime calls inside and outside the ranges, nested ranges, device time
under each SSSP phase, and nothing read from a program that only marks
where its phases begin."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import cell, phases, ranges, trace  # noqa: E402
from portbench.bench.cell import Context  # noqa: E402
from portbench.bench.spec import Benchmark  # noqa: E402

READERS = ("start_launches_per_search.bfs", "td_launches_per_level.bfs",
           "host_ms_per_td_level.bfs")


def _ranges(loop, ivs):
    return [(f"repro_torch.{loop}.{name}", float(s), float(e)) for name, s, e in ivs]


def _marks(host):
    """The same phases as empty marks: each range cut to 2 us."""
    return [(n, s, s + 2.0) if n.startswith("repro_torch.") else (n, s, e)
            for n, s, e in host]


def _calls(name, *at):
    return [(name, float(t), t + 1.0) for t in at]


# Two BFS searches, 0-1000 and 2000-3000 us.  The first: a top-down level
# (its relax and epilogue nested in it) and a bottom-up one with the core
# step; the second: two top-down levels.
BFS_RANGES = (
    _ranges("bfs", [("start", 10, 50), ("level.td", 50, 400), ("relax", 200, 300),
                    ("epilogue", 300, 400), ("sync", 400, 500), ("level.bu", 500, 800),
                    ("core", 520, 600), ("relax", 600, 700), ("epilogue", 700, 800),
                    ("sync", 800, 900), ("finish", 900, 950), ("done", 950, 952)])
    + _ranges("bfs", [("start", 2010, 2100), ("level.td", 2100, 2200),
                      ("relax", 2150, 2180), ("epilogue", 2180, 2200), ("sync", 2200, 2300),
                      ("level.td", 2300, 2500), ("relax", 2320, 2400),
                      ("epilogue", 2400, 2500), ("sync", 2500, 2600),
                      ("finish", 2600, 2700), ("done", 2700, 2702)]))
BFS_CALLS = (
    # before the first search's start, in its start (3), its top-down level
    # (the chunk count, two in the relax, three in the epilogue: 6), its
    # sync (a copy and a wait), its bottom-up level, its finish, after done
    _calls("cudaLaunchKernel", 5, 20, 30, 60, 210, 220, 310, 320, 510, 530, 610, 710, 910, 960)
    + _calls("cudaMemsetAsync", 40) + _calls("cudaLaunchKernelExC", 330)
    + _calls("cudaMemcpyAsync", 410) + _calls("cudaStreamSynchronize", 420)
    # the second search: 5 in start; its top-down levels 2 and 4, a copy in
    # its sync
    + _calls("cudaLaunchKernel", 2020, 2030, 2040, 2050, 2160, 2190, 2310, 2330, 2410, 2450)
    + _calls("cuLaunchKernel", 2060) + _calls("cudaMemcpyAsync", 2250)
    + _calls("aten::empty", 2070, 2340))
BFS = trace.Trace(spans=[(0.0, 1000.0), (2000.0, 3000.0)],
                  device=[("k", 60.0, 90.0), ("k", 560.0, 805.0), ("k", 2200.0, 2300.0)],
                  host=sorted(BFS_RANGES + BFS_CALLS, key=lambda h: h[1]))

# Two SSSP searches of two rounds and one, each round's bucket, relax and
# tally nested in it; the device time of each launch with the names around it
SSSP_RANGES = (
    _ranges("sssp", [("start", 5, 10), ("round", 10, 40), ("bucket", 10, 20),
                     ("relax", 20, 30), ("tally", 30, 40), ("sync", 40, 50),
                     ("round", 50, 80), ("bucket", 50, 60), ("relax", 60, 70),
                     ("tally", 70, 80), ("sync", 80, 90), ("finish", 90, 95),
                     ("done", 95, 96)])
    + _ranges("sssp", [("start", 205, 210), ("round", 210, 250), ("bucket", 212, 220),
                       ("relax", 220, 230), ("tally", 230, 250), ("sync", 250, 255),
                       ("finish", 255, 260), ("done", 270, 271)]))
P = "repro_torch.sssp."


def _under(*names):
    return frozenset(P + n if "::" not in n else n for n in names)


SSSP_LAUNCHES = [
    (10.0, _under("aten::where", "bucket", "round")), (5.0, _under("aten::min", "bucket", "round")),
    (40.0, _under("relax", "round")), (3.0, _under("aten::sum", "tally", "round")),
    (7.0, _under("aten::full", "start")), (2.0, _under("aten::copy_", "sync")),
    (12.0, _under("aten::eq", "bucket", "round")), (4.0, _under("aten::sum", "tally", "round")),
    (9.0, _under("aten::where", "bucket", "round")), (6.0, _under("aten::sum", "tally", "round")),
    (1.0, _under("aten::cat", "finish")), (30.0, frozenset({"aten::add"}))]
SSSP = trace.Trace(spans=[(0.0, 100.0), (200.0, 300.0)],
                   device=[("k", 12.0, 45.0), ("k", 60.0, 85.0), ("k", 200.0, 240.0)],
                   host=sorted(SSSP_RANGES, key=lambda h: h[1]), launches=SSSP_LAUNCHES)


def _ctx(kernel, tr, levels):
    return Context(kernel=kernel, setup_s=1.0, times_s=[0.1], edges=[10],
                   construction_s=0.5, levels=levels, trace=tr)


def _marked(tr):
    return trace.Trace(tr.spans, tr.device, _marks(tr.host), tr.launches)


def test_launches_inside_the_ranges():
    start = ranges.intervals(BFS, "bfs", "start")
    td = ranges.intervals(BFS, "bfs", "level.td")
    assert start == [(10, 50), (2010, 2100)] and len(td) == 3
    assert ranges.launches_in(BFS, start) == 3 + 5
    # a level's range holds the launches of the parts nested in it
    assert ranges.launches_in(BFS, td) == 6 + 2 + 4
    assert ranges.launches_in(BFS, ranges.intervals(BFS, "bfs", "sync")) == 1 + 1
    assert ranges.launches_in(BFS, ranges.intervals(BFS, "bfs", "level.bu")) == 4
    assert ranges.launches_in(BFS, [(0.0, 1000.0), (2000.0, 3000.0)]) == 17 + 12


def test_the_bfs_readers():
    b = Benchmark(ROOT)
    ctx = _ctx("bfs", BFS, [2, 2])
    assert b.reader("start_launches_per_search.bfs")(ctx) == pytest.approx(8 / 2)
    assert b.reader("td_launches_per_level.bfs")(ctx) == pytest.approx(12 / 3)
    assert b.reader("host_ms_per_td_level.bfs")(ctx) == pytest.approx(
        (350 + 100 + 200) / 1e3 / 3)


def test_device_time_under_each_sssp_phase():
    # each launch counted under the innermost phase around it and the round
    # that holds it: the round's parts sum to the rounds
    assert ranges.of(_ctx("sssp", SSSP, [2, 1]), "sssp") is SSSP
    assert trace.device_us_under(SSSP, P + "relax") == 40.0
    assert trace.device_us_under(SSSP, P + "bucket") == 10 + 5 + 12 + 9
    assert trace.device_us_under(SSSP, P + "tally") == 3 + 4 + 6
    assert trace.device_us_under(SSSP, P + "round") == 40 + 36 + 13
    assert sum(trace.device_us_under(SSSP, P + p) for p in ("start", "sync", "round", "finish")) \
        == sum(us for us, _ in SSSP_LAUNCHES) - 30.0


@pytest.mark.parametrize("name", READERS)
def test_a_reader_leaves_the_metric_out_without_the_ranges(name):
    b = Benchmark(ROOT)
    assert b.reader(name)(_ctx("bfs", BFS, [2, 2])) is not None
    assert b.reader(name)(_ctx("sssp", BFS, [2, 2])) is None
    assert b.reader(name)(_ctx("bfs", None, [2, 2])) is None
    # a program that marks where its phases begin (empty ranges)
    assert b.reader(name)(_ctx("bfs", _marked(BFS), [2, 2])) is None


@pytest.mark.parametrize("loop", ["bfs", "sssp"])
def test_phases_from_ranges_equal_those_from_marks(loop):
    tr = BFS if loop == "bfs" else SSSP
    assert ranges.of(_ctx(loop, tr, [2]), loop) is tr
    assert ranges.of(_ctx(loop, _marked(tr), [2]), loop) is None
    assert phases.phases(tr, loop) == phases.phases(_marked(tr), loop)
    b = Benchmark(ROOT)
    names = [m.name for m in b.per_layer if m.name.endswith("." + loop)
             and m.name not in READERS]
    assert len(names) > 5
    for name in names:
        assert b.reader(name)(_ctx(loop, tr, [2, 1])) == b.reader(name)(
            _ctx(loop, _marked(tr), [2, 1])), name


@pytest.mark.parametrize("kernel", ["bfs", "sssp"])
def test_the_program_profiled_on_the_cpu(kernel):
    """Two searches at scale 9 under the CPU profiler, each in the harness's
    span: one ``start`` range a search, a step range a level or round that
    holds its parts; no runtime call on the CPU."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cell.load_program(ROOT)
    from repro_torch.core.pipeline import Graph500Config, build, search_keys
    from repro_torch.core.plan import compile_plan

    kw = dict(scale=9, seed=5, n_roots=2, device="cpu")
    cfg = (Graph500Config.ladder("pre-g500", **kw) if kernel == "bfs"
           else Graph500Config(kernel="sssp", heavy_threshold=None, **kw))
    built = build(cfg)
    c = compile_plan(cfg.to_plan(), built, device="cpu")
    levels, td = [], 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for r in search_keys(cfg, built):
            with record_function(trace.SEARCH_SPAN):
                res = c.bfs(int(r))
            levels.append(int(res.stats.levels))
            td += int((res.stats.direction[:levels[-1]] == 0).sum())
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == trace.SEARCH_SPAN)
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.name != trace.SEARCH_SPAN]
    ctx = _ctx(kernel, trace.Trace(spans, [], host), levels)
    tr = ranges.of(ctx, kernel)
    assert tr is ctx.trace
    assert len(ranges.intervals(tr, kernel, "start")) == len(levels)
    b = Benchmark(ROOT)
    if kernel == "bfs":
        assert len(ranges.intervals(tr, "bfs", "level.td")) == td > 0
        assert b.reader("start_launches_per_search.bfs")(ctx) == 0.0
        assert b.reader("host_ms_per_td_level.bfs")(ctx) > 0.0
    else:
        assert len(ranges.intervals(tr, "sssp", "round")) == sum(levels)
        assert len(ranges.intervals(tr, "sssp", "tally")) == sum(levels)
