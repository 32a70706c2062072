"""The program's phase marks reduced to phases (``portbench/bench/phases.py``)
and the six readers of them, on hand-made traces and on a CPU profile of the
program."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import cell, phases, trace  # noqa: E402
from portbench.bench.cell import Context  # noqa: E402
from portbench.bench.spec import Benchmark  # noqa: E402
from portbench.tests.test_portbench_trace import TR  # noqa: E402

BFS_MARKS = [("start", 10), ("level.td", 50), ("compact", 100), ("relax", 200),
             ("epilogue", 300), ("stats", 350), ("stats", 380), ("stats", 390),
             ("sync", 400), ("level.bu", 500), ("core", 520), ("relax", 600),
             ("epilogue", 700), ("stats", 760), ("stats", 780), ("stats", 790),
             ("sync", 800), ("finish", 900), ("done", 950)]


def _marks(loop, marks):
    return [(f"repro_torch.{loop}.{name}", float(t), t + 2.0) for name, t in marks]


# one BFS search of two levels, 0-1000 us.  Device idle: 0-60 before start
# and 980-1000 after done (outside); 90-120 in level.td, 250-260 in relax and
# 905-960 in finish (launch); 150-180 in compact, 355-370 in stats, 410-560
# begun in sync and running on into level.bu, 805-850 in sync (sync)
BFS = trace.Trace(
    spans=[(0.0, 1000.0)],
    device=[("k", 60.0, 90.0), ("k", 120.0, 150.0), ("k", 180.0, 250.0),
            ("k", 260.0, 355.0), ("k", 370.0, 410.0), ("k", 560.0, 805.0),
            ("k", 850.0, 905.0), ("k", 960.0, 980.0)],
    host=sorted(_marks("bfs", BFS_MARKS) + [("aten::nonzero", 100.0, 190.0),
                                            ("aten::item", 400.0, 560.0)],
                key=lambda h: h[1]))

# two SSSP searches, 0-100 and 200-300 us, of two rounds and one.  Idle: 0-12
# (outside), 45-60 begun in sync into round, 85-100 begun in sync past done
# (sync); 240-300 begun in round (neither)
SSSP = trace.Trace(
    spans=[(0.0, 100.0), (200.0, 300.0)],
    device=[("k", 12.0, 45.0), ("k", 60.0, 85.0), ("k", 200.0, 240.0)],
    host=_marks("sssp", [("start", 5), ("round", 10), ("sync", 40), ("round", 50),
                         ("sync", 80), ("finish", 90), ("done", 95)])
    + _marks("sssp", [("start", 205), ("round", 210), ("sync", 250), ("finish", 260),
                      ("done", 270)]))


def _ctx(kernel, tr, levels):
    return Context(kernel=kernel, setup_s=1.0, times_s=[0.1], edges=[10],
                   construction_s=0.5, levels=levels, trace=tr)


def test_phases_of_a_bfs_search():
    p = phases.phases(BFS, "bfs")
    assert p.steps == 2 and p.syncs == 2 + 1 + 6
    assert p.marks == {"start": 1, "level.td": 1, "compact": 1, "relax": 2, "epilogue": 2,
                       "stats": 6, "sync": 2, "level.bu": 1, "core": 1, "finish": 1,
                       "done": 1}
    assert p.host_us == {"start": 40, "level.td": 50, "compact": 100, "relax": 200,
                         "epilogue": 50 + 60, "stats": 30 + 10 + 10 + 20 + 10 + 10,
                         "sync": 200, "level.bu": 20, "core": 80, "finish": 50}
    assert p.idle_us == {"level.td": 30, "relax": 10, "finish": 55, "compact": 30,
                         "stats": 15, "sync": 150 + 45}
    assert p.outside_us == 60 + 20
    assert p.sync_idle_us() == 240 and p.launch_idle_us() == 95
    idle = sum(p.idle_us.values()) + p.outside_us
    assert idle == pytest.approx(trace.idle_share(BFS) * BFS.window_us)


def test_phases_of_two_sssp_searches():
    p = phases.phases(SSSP, "sssp")
    assert p.steps == 3 and p.syncs == 3
    assert p.idle_us == {"sync": 15 + 15, "round": 60}
    assert p.outside_us == 12
    assert p.host_us["round"] == 30 + 30 + 40


def test_the_bfs_readers_on_the_hand_made_trace():
    b = Benchmark(ROOT)
    ctx = _ctx("bfs", BFS, [2])
    assert phases.of(ctx, "bfs").steps == sum(ctx.levels)
    assert b.reader("host_ms_per_level.bfs")(ctx) == pytest.approx(
        (50 + 200 + 110 + 20 + 80) / 1e3 / 2)
    assert b.reader("syncs_per_level.bfs")(ctx) == pytest.approx(4.5)
    assert b.reader("sync_idle_ms_per_level.bfs")(ctx) == pytest.approx(0.240 / 2)
    assert b.reader("launch_idle_ms_per_level.bfs")(ctx) == pytest.approx(0.095 / 2)


def test_the_sssp_readers_on_the_hand_made_trace():
    b = Benchmark(ROOT)
    ctx = _ctx("sssp", SSSP, [2, 1])
    assert phases.of(ctx, "sssp").steps == sum(ctx.levels)
    assert b.reader("sync_idle_ms_per_round.sssp")(ctx) == pytest.approx(0.030 / 3)


NEW = ("host_ms_per_level.bfs", "syncs_per_level.bfs", "sync_idle_ms_per_level.bfs",
       "launch_idle_ms_per_level.bfs", "sync_idle_ms_per_round.sssp")


@pytest.mark.parametrize("name", NEW)
def test_a_reader_leaves_the_metric_out_without_its_marks(name):
    b = Benchmark(ROOT)
    kernel = name.rsplit(".", 1)[1]
    other = "sssp" if kernel == "bfs" else "bfs"
    tr = BFS if kernel == "bfs" else SSSP
    assert b.reader(name)(_ctx(other, tr, [2])) is None
    assert b.reader(name)(_ctx(kernel, None, [2])) is None
    assert b.reader(name)(_ctx(kernel, TR, [3, 5])) is None   # a program without marks


def test_marks_leave_the_device_metrics_unchanged():
    b = Benchmark(ROOT)
    marked = trace.Trace(TR.spans, TR.device,
                         sorted(TR.host + _marks("bfs", [("start", 1), ("level.td", 5),
                                                         ("sync", 42), ("done", 99)])
                                + _marks("sssp", [("start", 201), ("round", 203),
                                                  ("done", 295)]), key=lambda h: h[1]),
                         TR.launches)
    for name, kernel in [("idle_share.bfs", "bfs"), ("ops_per_level.bfs", "bfs"),
                         ("idle_share.sssp", "sssp"), ("ops_per_round.sssp", "sssp")]:
        before = b.reader(name)(_ctx(kernel, TR, [3, 5]))
        assert before is not None
        assert b.reader(name)(_ctx(kernel, marked, [3, 5])) == before
    assert trace.busy_us(marked) == trace.busy_us(TR)


@pytest.mark.parametrize("kernel", ["bfs", "sssp"])
def test_the_program_profiled_on_the_cpu(kernel):
    """Two searches at scale 9 under the CPU profiler, each in the harness's
    span: the steps the phases count are the searches' levels."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cell.load_program(ROOT)
    from repro_torch.core.pipeline import Graph500Config, build, search_keys
    from repro_torch.core.plan import compile_plan

    kw = dict(scale=9, seed=5, n_roots=2, device="cpu")
    cfg = (Graph500Config.ladder("pre-g500", **kw) if kernel == "bfs"
           else Graph500Config(kernel="sssp", heavy_threshold=None, **kw))
    built = build(cfg)
    c = compile_plan(cfg.to_plan(), built, device="cpu")
    levels = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for r in search_keys(cfg, built):
            with record_function(trace.SEARCH_SPAN):
                levels.append(int(c.bfs(int(r)).stats.levels))
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == trace.SEARCH_SPAN)
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.name != trace.SEARCH_SPAN]
    p = phases.of(_ctx(kernel, trace.Trace(spans, [], host), levels), kernel)
    assert p.steps == sum(levels)
    assert p.marks["start"] == p.marks["done"] == len(levels)
    assert p.syncs >= sum(levels)
    assert sum(p.idle_us.values()) + p.outside_us == pytest.approx(
        sum(e - s for s, e in spans))
