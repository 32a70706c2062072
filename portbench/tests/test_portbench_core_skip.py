"""``core_skip_share.bfs``: the bottom-up levels that skipped the core step
(no core row left unvisited) over the bottom-up levels with a core, from the
program's counters over the traced window; left out where a program without
those counters (the loop before the skip) or a window without a core step
gives it nothing to read, and above 0 and at most 100% on a traced run of
each BFS cell at a scale whose core is a part of the vertices."""
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
METRIC = "core_skip_share.bfs"
BFS_CELLS = [c for c in BENCH.cells if BENCH.config(BENCH.cell(c).config)["kernel"] == "bfs"]


def _ctx(kernel="bfs", **counters):
    return Context(kernel=kernel, setup_s=1.0, times_s=[0.1, 0.1], edges=[10, 10],
                   construction_s=0.5, levels=[7, 6], counters=counters)


def test_skipped_core_steps_over_the_core_steps():
    read = BENCH.reader(METRIC)
    c = {"bfs.core_steps_skipped": 9, "bfs.core_steps": 16}
    assert read(_ctx(**c)) == pytest.approx(56.25)
    assert read(_ctx(**c, **{"bfs.core_words": 9})) == pytest.approx(56.25)
    assert read(_ctx(**{"bfs.core_steps_skipped": 0, "bfs.core_steps": 16})) == 0.0
    assert read(_ctx(**{"bfs.core_steps_skipped": 16, "bfs.core_steps": 16})) == 100.0
    assert read(_ctx("sssp", **c)) is None


@pytest.mark.parametrize("counters", [
    {}, {"bfs.core_words_read": 2_600, "bfs.core_words": 5_000},   # the parent's program
    {"bfs.core_steps_skipped": 5},                                 # one of the two
    {"bfs.core_steps_skipped": 0, "bfs.core_steps": 0}])           # no core step traced
def test_left_out_without_its_counters(counters):
    assert BENCH.reader(METRIC)(_ctx(**counters)) is None


def test_every_bfs_cell_reports_it():
    for name in BFS_CELLS:
        assert METRIC in {m.name for m in BENCH.metrics_for(name, trace=True)}


@pytest.mark.parametrize("name", BFS_CELLS)
def test_a_traced_run_reads_a_share(name):
    # at scale 13 the core's 4,096 rows are half the vertices, all visited
    # within a search's first levels (at 9 the core spans every vertex,
    # isolated ones too, and no level skips)
    r, _ = cell.run(ROOT, name, 2**31 + 41, 0.2, True, t_start=time.perf_counter(),
                    device="cpu", require_chip=False, overrides={"scale": 13, "search_keys": 8})
    assert r["correct"] is True
    assert 0.0 < r["metrics"][METRIC]["value"] <= 100.0
    assert r["metrics"][METRIC]["unit"] == "%"
