"""A cell is added as new files and new entries alone: on a copy of the
benchmark to which a change adds a cell of the specification's real weights,
a four-chip cell and a per-layer metric of a program counter, each new name
appended only to the ``workloads`` lists of the metrics it reports, the
invariants hold, ``BENCHMARK.json`` shows no edit beyond what was appended,
and the benchmark's own tests pass in the copy unedited."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import cell  # noqa: E402
from portbench.tests import invariants  # noqa: E402

TESTS = "portbench/tests"
# a per-layer metric read from the program's counter of frontier entries
COUNTER_READER = '''"""entries_per_round.sssp: frontier entries the relax reads a round."""


def read(ctx):
    n = ctx.counters.get("sssp.frontier_edges")
    if ctx.kernel != "sssp" or n is None or not sum(ctx.levels):
        return None
    return n / sum(ctx.levels)
'''


def _accepted(doc: dict) -> dict:
    """``doc`` cut to the accepted cells: the base that a change adds to,
    whatever cells later changes have added."""
    doc["workloads"] = [w for w in doc["workloads"] if w["name"] in invariants.ACCEPTED_CELLS]
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for c in m["workloads"] if c in invariants.ACCEPTED_CELLS]
    return doc


def _copy(tmp_path: Path) -> dict:
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    doc = _accepted(json.loads((ROOT / "BENCHMARK.json").read_text()))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))
    return doc


def _config(root: Path, name: str, like: str, **change) -> dict:
    cfg = json.loads((root / f"portbench/configs/{like}.json").read_text())
    for k, v in change.items():
        if v is None:
            cfg.pop(k)
        else:
            cfg[k] = v
    (root / f"portbench/configs/{name}.json").write_text(json.dumps(cfg, indent=1))
    return {"name": name, "source": "a test", "file": f"portbench/configs/{name}.json",
            "reduced": ["scale"], "why": "a test"}


def _report(doc: dict, cell: str, metrics) -> None:
    for m in doc["end_to_end"] + doc["per_layer"]:
        if m["name"] in metrics and "workloads" in m:
            m["workloads"].append(cell)


def _layers(doc: dict, kernel: str) -> list:
    return [m["name"] for m in doc["per_layer"]
            if m["name"].endswith("." + kernel) or m["name"] == "construction_s"]


def add_real_weight_cell(root: Path, doc: dict) -> None:
    """(a) ``sssp-f32-s9``: the specification's reals (``uniform_f32``) at
    scale 9, on one chip."""
    doc["configs"].append(_config(root, "g500-sssp-f32-s9", "g500-sssp-s22",
                                  weights="uniform_f32", max_weight=None, scale=9,
                                  search_keys=16))
    doc["workloads"].append({"name": "sssp-f32-s9", "config": "g500-sssp-f32-s9",
                             "traffic": "spec_keys", "chips": 1, "why": "a test"})
    _report(doc, "sssp-f32-s9", ["sssp_gteps"] + _layers(doc, "sssp"))


def add_four_chip_cell(root: Path, doc: dict) -> None:
    """(b) ``bfs-x4-s22``: a BFS cell on four chips, never run."""
    doc["configs"].append(_config(root, "g500-bfs-x4-s22", "g500-bfs-s22"))
    doc["workloads"].append({"name": "bfs-x4-s22", "config": "g500-bfs-x4-s22",
                             "traffic": "spec_keys", "chips": 4, "why": "a test"})
    _report(doc, "bfs-x4-s22", ["bfs_gteps"] + _layers(doc, "bfs"))


def add_counter_metric(root: Path, doc: dict) -> None:
    """(c) ``entries_per_round.sssp``, of source ``program_counter``, for
    every SSSP cell of the copy."""
    (root / "portbench/metrics/entries_per_round.sssp.py").write_text(COUNTER_READER)
    kernel = {c["name"]: json.loads((root / c["file"]).read_text())["kernel"]
              for c in doc["configs"]}
    cells = [w["name"] for w in doc["workloads"] if kernel[w["config"]] == "sssp"]
    doc["per_layer"].append({"name": "entries_per_round.sssp", "unit": "entries",
                             "better": "higher", "source": "program_counter",
                             "layer": "SSSP round loop", "moves": "sssp_gteps",
                             "workloads": cells})


def _added(tmp_path: Path, *changes) -> tuple:
    base = _copy(tmp_path)
    doc = json.loads(json.dumps(base))
    for change in changes:
        change(tmp_path, doc)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))
    return base, doc


def _pytest(root: Path, *args) -> subprocess.CompletedProcess:
    """The copy's own benchmark tests, run in the copy."""
    return subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                           "-p", "no:randomly", *args], cwd=root, capture_output=True,
                          text=True, timeout=900, env={**os.environ, "PYTHONPATH": "src"})


def test_a_cell_of_real_weights_a_four_chip_cell_and_a_counter_metric_are_added(tmp_path):
    base, doc = _added(tmp_path, add_real_weight_cell, add_four_chip_cell, add_counter_metric)
    assert invariants.edits(base, doc) == []
    assert invariants.problems(tmp_path) == []
    assert sum(w["chips"] == 4 for w in doc["workloads"]) == 1
    p = _pytest(tmp_path, f"{TESTS}/test_portbench_spec.py", f"{TESTS}/test_portbench_trace.py")
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]


def test_every_benchmark_test_passes_with_a_four_chip_cell_and_a_counter_metric(tmp_path):
    """The cell of real weights stays out: the program has integer weights
    only, so a run of it is not correct (``test_portbench_weights.py``)."""
    base, doc = _added(tmp_path, add_four_chip_cell, add_counter_metric)
    assert invariants.edits(base, doc) == []
    assert invariants.problems(tmp_path) == []
    p = _pytest(tmp_path, TESTS, "--ignore", f"{TESTS}/{Path(__file__).name}")
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]
    # the counter is counted on the CPU too, so the faults' traced run of
    # each SSSP cell expected the metric and found it
    r, _ = cell.run(tmp_path, "sssp-spec-s22", 2**31 + 3, 0.2, True,
                    t_start=time.perf_counter(), device="cpu", require_chip=False,
                    overrides={"scale": 9, "search_keys": 16})
    assert r["correct"] is True
    assert r["metrics"]["entries_per_round.sssp"]["value"] > 0


def test_edits_finds_what_is_not_appended():
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert invariants.edits(old, old) == []

    def changed(f):
        new = json.loads(json.dumps(old))
        f(new)
        return invariants.edits(old, new)
    assert changed(lambda d: d["workloads"].append({"name": "x"})) == []
    assert changed(lambda d: d["end_to_end"][0]["workloads"].append("x")) == []
    assert changed(lambda d: d["end_to_end"][0].update(bound=0.2)) != []
    assert changed(lambda d: d["workloads"].pop()) != []
    assert changed(lambda d: d["workloads"].insert(0, {"name": "x"})) != []
    assert changed(lambda d: d["end_to_end"][-1].update(workloads=["bfs-spec-s22"])) != []
    assert changed(lambda d: d["per_layer"][0]["workloads"].reverse()) != []
    assert changed(lambda d: d.update(run_seconds=50)) != []
