"""``correct`` on a whole run at a tiny size on the CPU (the harness's look
for a card skipped): true for the program as it is, false with the timed
path broken underneath, once per fault a cell can have, and false for the
control (the reference with one guarantee broken in the program's place).

The cases are every one-chip cell of ``BENCHMARK.json``, each with the
metrics its entries say it reports.  A one-chip cell has no exchange
between chips to leave out.  A four-chip cell brings its own faults,
the exchange left out among them, in the change that adds it."""
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import cell  # noqa: E402
from portbench.bench.control import run_control  # noqa: E402
from portbench.bench.spec import Benchmark  # noqa: E402
from portbench.tests import invariants  # noqa: E402

BENCH = Benchmark(ROOT)
CELLS = invariants.one_chip_cells(ROOT)
SMALL = {"scale": 9, "search_keys": 16}
SEED = 2**31 + 77


def _run(name, trace=False):
    return cell.run(ROOT, name, SEED, 0.3, trace, t_start=time.perf_counter(),
                    device="cpu", require_chip=False, overrides=SMALL)[0]


def _plan():
    cell.load_program(ROOT)
    from repro_torch.core import plan
    from repro_torch.core.hybrid_bfs import BFSResult
    return plan.CompiledBFS, BFSResult


@pytest.mark.parametrize("name", CELLS)
def test_the_program_as_it_is_is_correct(name):
    r = _run(name)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())
    metric = invariants.kernel_metric(BENCH, name)
    # the end-to-end metrics the entries give the cell, each taken on the host
    assert set(r["metrics"]) == {m.name for m in BENCH.metrics_for(name, trace=False)
                                 if m.source == "host_clock"}
    assert r["metrics"][metric]["value"] > 0


def _readable_without_a_device_trace(name, counters):
    """The per-layer metrics of a cell that a run with no device trace can
    read: not those of the device trace, and of the others those whose
    reader gives a value from what such a run holds (the program's spans
    and counters, the host's clock)."""
    ctx = cell.Context(kernel=invariants.kernel_of(BENCH, name), setup_s=1.0,
                       times_s=[0.1, 0.2], edges=[10, 10], construction_s=0.5,
                       levels=[3, 4], num_vertices=1 << SMALL["scale"], counters=counters)
    return {m.name for m in BENCH.metrics_for(name, trace=True)
            if m.source != "device_trace" and BENCH.reader(m.name)(ctx) is not None}


@pytest.mark.parametrize("name", CELLS)
def test_the_traced_run_reports_its_layer_metrics_it_can_read(name):
    cell.load_program(ROOT)
    from repro_torch import tracing
    before = tracing.counters()
    r = _run(name, trace=True)
    counters = {k: n - before.get(k, 0) for k, n in tracing.counters().items()}
    assert r["correct"] is True
    # no device trace on the CPU: only what the program and the host give
    assert set(r["metrics"]) == _readable_without_a_device_trace(name, counters)


def _unchanged(monkeypatch):
    """A search whose steps return the state unchanged: only the root."""
    Compiled, Result = _plan()
    orig = Compiled._traverse

    def traverse(self, root):
        res = orig(self, root)
        parent = torch.full_like(res.parent, -1)
        level = torch.full_like(res.level, -1)
        parent[root], level[root] = root, 0
        return Result(parent, level, res.stats)
    monkeypatch.setattr(Compiled, "_traverse", traverse)


def _half_left_out(monkeypatch):
    """Every other search's answer left out: the last answer handed back."""
    Compiled, _ = _plan()
    orig, last = Compiled.bfs, []

    def bfs(self, roots):
        if last and len(last) % 2:
            last.append(last[-1])
            return last[-2]
        last.append(orig(self, roots))
        return last[-1]
    monkeypatch.setattr(Compiled, "bfs", bfs)


def _altered(monkeypatch):
    """One answer altered where it is produced: a reached vertex's parent
    set to the vertex itself."""
    Compiled, Result = _plan()
    orig = Compiled._traverse

    def traverse(self, root):
        res = orig(self, root)
        parent = res.parent.clone()
        ids = torch.nonzero((parent >= 0) & (torch.arange(parent.numel()) != root))
        v = int(ids[0])
        parent[v] = v
        return Result(parent, res.level, res.stats)
    monkeypatch.setattr(Compiled, "_traverse", traverse)


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered],
                         ids=["state_unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    r = _run(name)
    assert r["correct"] is False
    assert r["failed"] > 0
    if fault is _half_left_out:      # every stale answer, sampled or not
        checked = BENCH.traffic(BENCH.cell(name).traffic)["checked_searches"]
        assert r["checks"]["root_invalid"]["value"] >= (r["attempted"] - checked) // 2 - 1
        assert r["checks"]["seeded_root_invalid"]["value"] >= checked // 2 - 1


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    doc = {**BENCH.config(BENCH.cell(name).config), **SMALL}
    for seed in (SEED, SEED + 1, SEED + 2):
        for checked in (False, True):
            res = run_control(doc, BENCH.weights(doc.get("weights")), seed, "cpu", 4,
                              checked=checked)
            assert res["correct"] is False
            assert res["numbers"]["graph_mismatch"] > 0
