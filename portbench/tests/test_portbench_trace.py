"""The trace reduction and the per-layer readers on a hand-made trace."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import roofline, trace  # noqa: E402
from portbench.bench.cell import Context  # noqa: E402
from portbench.bench.spec import Benchmark  # noqa: E402

# two searches, 0-100 us and 200-300 us; the harness's work between them
# (150-160) lies outside both
TR = trace.Trace(
    spans=[(0.0, 100.0), (200.0, 300.0)],
    device=[("core_spmv_kernel", 10.0, 30.0), ("scatter", 20.0, 40.0),
            ("frontier_update_kernel", 60.0, 62.0), ("scatter", 210.0, 290.0)],
    host=[("aten::item", 40.0, 60.0), ("aten::nonzero", 45.0, 55.0),
          ("aten::where", 62.0, 100.0), ("aten::scatter_reduce", 200.0, 215.0)],
    launches=[(80.0, frozenset({"aten::scatter_reduce", "outer"})),
              (20.0, frozenset({"aten::add"}))])


def test_busy_idle_and_names():
    assert trace.busy_us(TR) == pytest.approx(30 + 2 + 80)
    assert TR.window_us == 200.0
    assert trace.idle_share(TR) == pytest.approx(1 - 112 / 200)
    assert trace.device_by_name(TR)["scatter"] == (100.0, 2)
    assert trace.kernel_time(TR, "core_spmv") == (20.0, 1)
    assert trace.device_us_under(TR, "aten::scatter_reduce") == 80.0


def test_idle_gaps_by_host_operation():
    gaps = trace.idle_gaps(TR)
    # 0-10: nothing; 40-60: aten::item (20 of 20); 62-100: aten::where;
    # 200-210: aten::scatter_reduce; 290-300: nothing
    assert gaps == {trace.NO_OP: 20.0, "aten::item": 20.0, "aten::where": 38.0,
                    "aten::scatter_reduce": 10.0}
    b = trace.breakdown(TR)
    assert b["device_ops"][0] == ["scatter", 100.0 / 1e6]
    assert len(b["idle_gaps"]) <= 10


def test_clip_to_the_search_spans():
    spans = [(0.0, 100.0), (200.0, 300.0)]
    starts = [0.0, 200.0]
    assert trace._clip(spans, starts, 150.0, 160.0) is None
    assert trace._clip(spans, starts, 90.0, 120.0) == (90.0, 100.0)
    assert trace._clip(spans, starts, -5.0, 1.0) is None


def _ctx(kernel, **kw):
    base = dict(kernel=kernel, setup_s=1.0, times_s=[0.1],
                edges=[10], construction_s=0.5, levels=[3, 5], trace=TR,
                core_words=8, bitmap_words=1024)
    base.update(kw)
    return Context(**base)


def test_readers_on_the_hand_made_trace():
    b = Benchmark(ROOT)
    bfs, sssp = _ctx("bfs", core_outputs=[torch.tensor([0, 40], dtype=torch.int32)]), _ctx("sssp")
    assert b.reader("idle_share.bfs")(bfs) == pytest.approx(100 * (1 - 112 / 200))
    assert b.reader("idle_share.bfs")(sssp) is None
    assert b.reader("ops_per_level.bfs")(bfs) == pytest.approx(4 / 8)
    assert b.reader("ops_per_round.sssp")(sssp) == pytest.approx(4 / 8)
    share = b.reader("core_spmv_roofline.bfs")(bfs)
    bound = roofline.core_spmv_bound_s(torch.tensor([0, 40]), 8)
    assert share == pytest.approx(100 * bound / 20e-6)
    fu = b.reader("frontier_update_roofline.bfs")(bfs)
    assert fu == pytest.approx(100 * roofline.frontier_update_bound_s(1024) / 2e-6)
    for name in ("core_spmv_roofline.bfs", "frontier_update_roofline.bfs"):
        assert b.reader(name)(_ctx("bfs", trace=None)) is None


# one traced SSSP search of three rounds: the relax's four kernels, 300 us of
# device time between them, beside a kernel of another name
RELAX = trace.Trace(
    spans=[(0.0, 1000.0)],
    device=[("sssp_relax_count_kernel", 0.0, 20.0), ("sssp_relax_offsets_kernel", 20.0, 30.0),
            ("sssp_relax_compact_kernel", 30.0, 50.0), ("sssp_relax_kernel", 50.0, 300.0),
            ("reduce_kernel", 300.0, 400.0)],
    host=[])


def test_the_sssp_relax_roofline():
    b = Benchmark(ROOT)
    read = b.reader("sssp_relax_roofline.sssp")
    ctx = _ctx("sssp", trace=RELAX, levels=[3], num_vertices=1 << 10,
               counters={"sssp.frontier_edges": 40_000})
    bound = (4 * 1024 * 3 + 8 * 40_000) / roofline.HBM_BYTES_PER_S
    assert read(ctx) == pytest.approx(100 * bound / 300e-6)
    assert 0 < read(ctx) <= 100
    assert read(_ctx("sssp", trace=RELAX, levels=[3], num_vertices=1 << 10)) is None  # no counter
    assert read(_ctx("sssp", levels=[3], num_vertices=1 << 10,
                     counters={"sssp.frontier_edges": 40_000})) is None  # no relax kernel
    assert read(_ctx("bfs", trace=RELAX, levels=[3],
                     counters={"sssp.frontier_edges": 40_000})) is None


def test_readers_without_a_trace_leave_the_metric_out():
    """Every metric of the device trace; a metric of the program's spans or
    counters is held by a test of its own reader."""
    b = Benchmark(ROOT)
    for m in b.per_layer:
        if m.source == "device_trace":
            assert b.reader(m.name)(_ctx("bfs", trace=None)) is None
            assert b.reader(m.name)(_ctx("sssp", trace=None)) is None
