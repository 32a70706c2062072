"""``correct`` on a whole run at a tiny size on the CPU (the harness's look
for a card skipped): true for the program as it is, false with the timed
path broken underneath, once per fault a cell can have, and false for the
control (the reference with one guarantee broken in the program's place).
Neither cell has an exchange between chips to leave out: both run on one."""
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

CELLS = ["bfs-spec-s22", "sssp-spec-s22"]
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
    metric = "bfs_gteps" if name.startswith("bfs") else "sssp_gteps"
    assert set(r["metrics"]) == {metric, "setup_s"}
    assert r["metrics"][metric]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_traced_run_reports_its_layer_metrics_it_can_read(name):
    r = _run(name, trace=True)
    assert r["correct"] is True
    # no device trace on the CPU: only the program's own span is read
    assert set(r["metrics"]) == {"construction_s"}


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
        checked = Benchmark(ROOT).traffic("spec_keys")["checked_searches"]
        assert r["checks"]["root_invalid"]["value"] >= (r["attempted"] - checked) // 2 - 1
        assert r["checks"]["seeded_root_invalid"]["value"] >= checked // 2 - 1


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    b = Benchmark(ROOT)
    c = b.cell(name)
    doc = {**b.config(c.config), **SMALL}
    for seed in (SEED, SEED + 1, SEED + 2):
        for checked in (False, True):
            res = run_control(doc, b.weights(doc.get("weights")), seed, "cpu", 4,
                              checked=checked)
            assert res["correct"] is False
            assert res["numbers"]["graph_mismatch"] > 0
