"""The BFS relax's readers on a hand-made trace and hand-made counters:
``relax_ms_per_search.bfs`` (device time of the ``bfs_relax`` kernels per
traced search) and ``bu_read_share.bfs`` (the bottom-up walks' entries over
the unvisited adjacency); each leaves its metric out where a program
without the kernel or the counters gives it nothing to read."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import trace  # noqa: E402
from portbench.bench.cell import Context  # noqa: E402
from portbench.bench.spec import Benchmark  # noqa: E402

# two traced BFS searches: a top-down level's scan and relax (40 us in four
# kernels), a bottom-up level's relax (60 us), beside kernels of other names
RELAX = trace.Trace(
    spans=[(0.0, 500.0), (600.0, 1000.0)],
    device=[("bfs_relax_count_kernel", 0.0, 5.0), ("bfs_relax_offsets_kernel", 5.0, 10.0),
            ("bfs_relax_compact_kernel", 10.0, 15.0), ("bfs_relax_top_down_kernel", 15.0, 40.0),
            ("frontier_update_kernel", 40.0, 45.0), ("core_spmv_kernel", 600.0, 700.0),
            ("bfs_relax_bottom_up_kernel", 700.0, 760.0), ("sssp_relax_kernel", 800.0, 900.0)],
    host=[])


def _ctx(kernel="bfs", **kw):
    base = dict(kernel=kernel, setup_s=1.0, times_s=[0.1, 0.1], edges=[10, 10],
                construction_s=0.5, levels=[3, 4], trace=RELAX,
                counters={"bfs.bu_entries_read": 1_500, "bfs.bu_entries_unvisited": 60_000})
    base.update(kw)
    return Context(**base)


def test_relax_ms_per_search():
    read = Benchmark(ROOT).reader("relax_ms_per_search.bfs")
    assert read(_ctx()) == pytest.approx((40.0 + 60.0) / 1e3 / 2)
    no_kernel = trace.Trace(spans=RELAX.spans, host=[],
                            device=[d for d in RELAX.device if "bfs_relax" not in d[0]])
    assert read(_ctx(trace=no_kernel)) is None       # the parent's program
    assert read(_ctx(trace=None)) is None
    assert read(_ctx("sssp")) is None


def test_bu_read_share():
    read = Benchmark(ROOT).reader("bu_read_share.bfs")
    assert read(_ctx()) == pytest.approx(2.5)
    assert read(_ctx(counters={})) is None            # the parent's program
    assert read(_ctx(counters={"bfs.bu_entries_read": 0,
                               "bfs.bu_entries_unvisited": 0})) is None   # no bottom-up level
    assert read(_ctx(counters={"bfs.bu_entries_read": 0,
                               "bfs.bu_entries_unvisited": 10})) == 0.0
    assert read(_ctx("sssp")) is None
    assert read(_ctx(trace=None)) == pytest.approx(2.5)   # the program's counters alone
