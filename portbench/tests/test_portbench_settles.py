"""``settles_per_vertex.sssp``: the rounds' frontier vertices over the
vertices reached, from the program's counters over the traced window; left
out where a program without those counters (the integer engine before them)
gives it nothing to read, and at least 1 on a traced run of each SSSP cell,
since every reached vertex enters a frontier."""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import cell  # noqa: E402
from portbench.bench.cell import Context  # noqa: E402
from portbench.bench.spec import Benchmark  # noqa: E402

BENCH = Benchmark(ROOT)
METRIC = "settles_per_vertex.sssp"
SSSP_CELLS = [c for c in BENCH.cells if BENCH.config(BENCH.cell(c).config)["kernel"] == "sssp"]


def _ctx(kernel="sssp", **counters):
    return Context(kernel=kernel, setup_s=1.0, times_s=[0.1, 0.1], edges=[10, 10],
                   construction_s=0.5, levels=[30, 40], counters=counters)


def test_frontier_vertices_over_reached_vertices():
    read = BENCH.reader(METRIC)
    c = {"sssp.frontier_vertices": 1_500, "sssp.reached_vertices": 1_000}
    assert read(_ctx(**c)) == pytest.approx(1.5)
    assert read(_ctx(**c, **{"sssp.frontier_edges": 9})) == pytest.approx(1.5)
    assert read(_ctx("bfs", **c)) is None


@pytest.mark.parametrize("counters", [
    {}, {"sssp.frontier_edges": 40_000},                # a program without the counters
    {"sssp.frontier_vertices": 5},                      # one of the two
    {"sssp.frontier_vertices": 0, "sssp.reached_vertices": 0}])   # nothing traced
def test_left_out_without_its_counters(counters):
    assert BENCH.reader(METRIC)(_ctx(**counters)) is None


def test_every_sssp_cell_reports_it():
    for name in SSSP_CELLS:
        assert METRIC in {m.name for m in BENCH.metrics_for(name, trace=True)}


@pytest.mark.parametrize("name", SSSP_CELLS)
def test_a_traced_run_reads_at_least_one(name):
    r, _ = cell.run(ROOT, name, 2**31 + 21, 0.2, True, t_start=time.perf_counter(),
                    device="cpu", require_chip=False, overrides={"scale": 9, "search_keys": 16})
    assert r["correct"] is True
    assert r["metrics"][METRIC]["value"] >= 1.0
    assert r["metrics"][METRIC]["unit"] == "x"
