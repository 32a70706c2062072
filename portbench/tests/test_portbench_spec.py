"""BENCHMARK.json and the files it names: discovery by name, the contract's
names and units, the invariants of whatever cells it holds
(:mod:`portbench.tests.invariants`), each shown to fail where broken, and a
cell, configuration, traffic mix, traffic kind and metric added as new
files."""
import json
import re
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench.spec import NAME_RE, UNIT_RE, Benchmark  # noqa: E402
from portbench.bench import cell  # noqa: E402
from portbench.bench.cell import Context  # noqa: E402
from portbench.tests import invariants  # noqa: E402

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys_and_paths():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["portbench"]
    assert DOC["command"][1] == "portbench/run.py"
    assert (ROOT / DOC["command"][1]).is_file()
    assert 1 <= DOC["run_seconds"] <= 51
    assert len(json.dumps(DOC)) < 64 * 1024


@pytest.mark.parametrize("name", [x["name"] for x in DOC["configs"] + DOC["workloads"]
                                  + DOC["end_to_end"] + DOC["per_layer"]])
def test_names_keep_to_the_allowed_characters(name):
    assert NAME_RE.match(name)


@pytest.mark.parametrize("metric", DOC["end_to_end"] + DOC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT_RE.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in DOC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in DOC["end_to_end"]}
        assert metric["layer"] and "\n" not in metric["layer"]
        if metric["name"].endswith("_roofline") or "_roofline." in metric["name"]:
            assert metric["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    """``setup_s``, the end-to-end metric of the cell's kernel, and a layer."""
    assert invariants.reports(ROOT) == []


def test_cells_configs_traffic_and_readers_are_found_by_name():
    """And every other invariant of :mod:`portbench.tests.invariants`."""
    assert invariants.problems(ROOT) == []


def _cell(doc, name, config="g500-sssp-s22", chips=1, traffic="spec_keys", reports=None):
    """Appends a cell, and its name to the ``workloads`` of the metrics named
    in ``reports`` (by default its kernel's end-to-end metric and the
    per-layer metrics of its kernel)."""
    doc["workloads"].append({"name": name, "config": config, "traffic": traffic,
                             "chips": chips, "why": "a test"})
    kernel = "bfs" if "bfs" in config else "sssp"
    if reports is None:
        reports = [m["name"] for m in doc["end_to_end"] + doc["per_layer"]
                   if m["name"] == kernel + "_gteps" or m["name"].endswith("." + kernel)]
    for m in doc["end_to_end"] + doc["per_layer"]:
        if m["name"] in reports and "workloads" in m:
            m["workloads"].append(name)


def _two_chips(doc, root):
    _cell(doc, "sssp-two-s22", chips=2, traffic="spec_keys_0")


def _twenty_five(doc, root):
    for i in range(25 - len(doc["workloads"])):
        _cell(doc, f"sssp-more-{i}", traffic=f"spec_keys_{i}")


def _two_four_chip(doc, root):
    # a second four-chip cell beside three one-chip cells
    _cell(doc, "sssp-one-s22", traffic="spec_keys_0")
    _cell(doc, "bfs-four-a", config="g500-bfs-s22", chips=4, traffic="spec_keys_1")
    _cell(doc, "bfs-four-b", config="g500-bfs-s22", chips=4, traffic="spec_keys_2")


def _no_kernel_metric(doc, root):
    # an SSSP cell that reports BFS's end-to-end metric and SSSP's layers:
    # setup_s and another end-to-end metric, but not its kernel's
    _cell(doc, "sssp-wrong-s22", traffic="spec_keys_0",
          reports=["bfs_gteps", "relax_ms_per_search.sssp"])


def _accepted_gone(doc, root):
    doc["workloads"] = [w for w in doc["workloads"] if w["name"] != "bfs-spec-s22"]


def _same_pair(doc, root):
    _cell(doc, "sssp-again-s22")


def _other_kernel(doc, root):
    cfg = json.loads((root / "portbench/configs/g500-sssp-s22.json").read_text())
    cfg["kernel"] = "pagerank"
    (root / "portbench/configs/g500-pr-s22.json").write_text(json.dumps(cfg))
    doc["configs"].append({"name": "g500-pr-s22", "source": "a test",
                           "file": "portbench/configs/g500-pr-s22.json",
                           "reduced": ["scale"], "why": "a test"})


@pytest.mark.parametrize("change,invariant", [
    (_two_chips, invariants.chips), (_twenty_five, invariants.cell_count),
    (_two_four_chip, invariants.chips), (_no_kernel_metric, invariants.reports),
    (_accepted_gone, invariants.accepted_cells), (_same_pair, invariants.pairs),
    (_other_kernel, invariants.kernels),
], ids=["two_chips", "25_cells", "second_four_chip_cell", "no_kernel_metric",
        "accepted_cell_gone", "pair_twice", "other_kernel"])
def test_a_benchmark_that_breaks_an_invariant_fails_it(tmp_path, change, invariant):
    """Each invariant, held by the benchmark as it is, fails on a copy that
    breaks it and no other."""
    _, doc = _tmp_benchmark(tmp_path)
    mix = (ROOT / "portbench/traffic/spec_keys.json").read_text()
    for i in range(24):     # a mix of its own for each added cell
        (tmp_path / "portbench/traffic" / f"spec_keys_{i}.json").write_text(mix)
    change(doc, tmp_path)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    assert invariant(ROOT) == []
    assert invariant(tmp_path) != []
    assert [p for f in invariants.INVARIANTS if f is not invariant
            for p in f(tmp_path)] == []


def _tmp_benchmark(tmp_path):
    """A checkout in ``tmp_path``: a copy of BENCHMARK.json and the benchmark
    folder, and the program's sources."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    return bench_dir, json.loads((ROOT / "BENCHMARK.json").read_text())


def test_a_cell_added_as_new_files_is_found(tmp_path):
    bench_dir, doc = _tmp_benchmark(tmp_path)
    cfg = json.loads((bench_dir / "configs" / "g500-bfs-s22.json").read_text())
    cfg["scale"] = 21
    (bench_dir / "configs" / "g500-bfs-s21.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "spec_keys.json").read_text())
    mix["checked_searches"] = 16
    (bench_dir / "traffic" / "spec_keys_all.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "searches.bfs.py").write_text(
        "def read(ctx):\n    return len(ctx.times_s)\n")
    doc["configs"].append({"name": "g500-bfs-s21", "source": "a test",
                           "file": "portbench/configs/g500-bfs-s21.json",
                           "reduced": ["scale"], "why": "a test"})
    doc["workloads"].append({"name": "bfs-all-s21", "config": "g500-bfs-s21",
                             "traffic": "spec_keys_all", "chips": 1, "why": "a test"})
    doc["per_layer"].append({"name": "searches.bfs", "unit": "searches",
                             "better": "higher", "source": "host_clock",
                             "layer": "device", "moves": "bfs_gteps",
                             "workloads": ["bfs-all-s21"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    b = Benchmark(tmp_path)
    assert b.bench_dir == bench_dir
    cell = b.cell("bfs-all-s21")
    assert b.config(cell.config)["scale"] == 21
    assert b.traffic(cell.traffic)["checked_searches"] == 16
    names = [m.name for m in b.metrics_for("bfs-all-s21", trace=True)]
    assert names == ["searches.bfs"]
    ctx = Context(kernel="bfs", setup_s=1.0, times_s=[0.1, 0.2], edges=[5, 5],
                  construction_s=0.5)
    assert b.reader("searches.bfs")(ctx) == 2
    assert b.reader("bfs_gteps")(ctx) == pytest.approx(2 / (0.1 / 5 + 0.2 / 5) / 1e9)


# a traffic kind of two searches a call, each key paired with the one
# ``stride`` places on
PAIRS = """
def warm(prog, mix, seed):
    prog.compiled.bfs(prog.roots[0])


def window(prog, mix, seed, rec):
    n, i = len(prog.roots), 0
    while rec.more():
        a, b = i % n, (i + mix["stride"]) % n
        rec.call([a, b], lambda: [prog.compiled.bfs(prog.roots[a]),
                                  prog.compiled.bfs(prog.roots[b])])
        i += 1
"""


def test_a_traffic_kind_added_as_new_files_runs(tmp_path):
    bench_dir, doc = _tmp_benchmark(tmp_path)
    (bench_dir / "traffic" / "pairs.py").write_text(PAIRS)
    (bench_dir / "traffic" / "key_pairs.json").write_text(json.dumps(
        {"kind": "pairs", "stride": 5, "trace_searches": 2, "checked_searches": 4}))
    (bench_dir / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx.times_s) / sum(ctx.times_s)\n")
    doc["workloads"].append({"name": "bfs-pairs-s22", "config": "g500-bfs-s22",
                             "traffic": "key_pairs", "chips": 1, "why": "a test"})
    doc["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                              "bound": 0.05, "source": "host_clock",
                              "workloads": ["bfs-pairs-s22"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    result, lines = cell.run(tmp_path, "bfs-pairs-s22", 2**31 + 5, 0.2, False,
                             t_start=time.perf_counter(), device="cpu",
                             require_chip=False, overrides={"scale": 9, "search_keys": 16})
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "calls_per_s"}
    calls = [x for x in lines if x.startswith("window: ")][0].split()[1]
    assert result["attempted"] == 2 * int(calls) + 2 * 4
    assert all(c["value"] == 0 for c in result["checks"].values())


def test_a_bad_name_is_refused():
    b = Benchmark(ROOT)
    with pytest.raises(ValueError):
        b.traffic("../configs/x")
    with pytest.raises(KeyError):
        b.config("g500-bfs-s99")
    b.config_files["g500-bfs-s22"] = "src/repro_torch/core/pipeline.py"
    with pytest.raises(ValueError):
        b.config("g500-bfs-s22")
