"""``core_read_share.bfs``: the words of the dense core that the bottom-up
levels' ``core_spmv`` launches read over the core's words times those
launches, from the program's counters over the traced window; left out where
a program without those counters (the kernel before its early exit) gives it
nothing to read, and above 0 and at most 100% on a traced run of each BFS
cell."""
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
METRIC = "core_read_share.bfs"
BFS_CELLS = [c for c in BENCH.cells if BENCH.config(BENCH.cell(c).config)["kernel"] == "bfs"]


def _ctx(kernel="bfs", **counters):
    return Context(kernel=kernel, setup_s=1.0, times_s=[0.1, 0.1], edges=[10, 10],
                   construction_s=0.5, levels=[7, 6], counters=counters)


def test_words_read_over_the_core_words_launched():
    read = BENCH.reader(METRIC)
    c = {"bfs.core_words_read": 2_600, "bfs.core_words": 5_000}
    assert read(_ctx(**c)) == pytest.approx(52.0)
    assert read(_ctx(**c, **{"bfs.bu_entries_read": 9})) == pytest.approx(52.0)
    assert read(_ctx(**{"bfs.core_words_read": 0, "bfs.core_words": 5_000})) == 0.0
    assert read(_ctx("sssp", **c)) is None


@pytest.mark.parametrize("counters", [
    {}, {"bfs.bu_entries_read": 1_500, "bfs.bu_entries_unvisited": 60_000},  # the parent's program
    {"bfs.core_words_read": 5},                          # one of the two
    {"bfs.core_words_read": 0, "bfs.core_words": 0}])    # no core launch traced
def test_left_out_without_its_counters(counters):
    assert BENCH.reader(METRIC)(_ctx(**counters)) is None


def test_every_bfs_cell_reports_it():
    for name in BFS_CELLS:
        assert METRIC in {m.name for m in BENCH.metrics_for(name, trace=True)}


@pytest.mark.parametrize("name", BFS_CELLS)
def test_a_traced_run_reads_a_share(name):
    r, _ = cell.run(ROOT, name, 2**31 + 37, 0.2, True, t_start=time.perf_counter(),
                    device="cpu", require_chip=False, overrides={"scale": 9, "search_keys": 16})
    assert r["correct"] is True
    assert 0.0 < r["metrics"][METRIC]["value"] <= 100.0
    assert r["metrics"][METRIC]["unit"] == "%"
