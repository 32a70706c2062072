"""The benchmark's description: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is found by its name:

  configuration  the ``file`` of its entry in ``BENCHMARK.json``, under
                 ``portbench/configs/``
  traffic mix    ``portbench/traffic/<traffic>.json``: parameters, and the
                 ``kind`` of traffic that reads them
  traffic kind   ``portbench/traffic/<kind>.py``: ``warm(prog, mix, seed)``
                 and ``window(prog, mix, seed, rec)``, which drive the
                 program (see :mod:`portbench.bench.cell`)
  per-layer      ``portbench/metrics/<metric>.py`` (a ``read(ctx)`` function)
  edge weights   ``portbench/weights/<scheme>.py``, named by a configuration's
                 ``"weights"`` key (``hash_int`` where it has none): the
                 weights' definition and their control (``reference``), how
                 to read the program's weight and answer planes
                 (``decode_weights``, ``decode_distances``) and to write the
                 reference's answers in them (``encode_weights``,
                 ``encode_distances``), whether a weight can be 0
                 (``ZERO_WEIGHTS``), and the program's knobs (``program_kw``)

so a later cell, configuration, mix, kind, metric or weight scheme is a new
file and a new entry, with no edit to the harness or its tests.

Adding a cell: the change adds, as new files, its configuration under
``configs/`` (and, where it needs them, a traffic mix, a traffic kind, a
weight scheme and the readers of new per-layer metrics), and, as new entries
appended to the lists of ``BENCHMARK.json``, the configuration to
``configs``, the cell to ``workloads`` and each new metric to ``end_to_end``
or ``per_layer``.  The one change to an entry that is there: the new cell's
name appended to the ``workloads`` list of each metric it reports, at least
``<kernel>_gteps`` of its configuration's kernel and one per-layer metric
(``setup_s`` has no list: every cell reports it).  Nothing else changes: no
file there, no bound, no item of a list taken out or reordered.  The tests
hold the invariants over whatever cells there are
(``portbench/tests/invariants.py``: found by name, at most 24 cells, 1 or 4
chips with at most a quarter of the cells, or one, on 4, the kernel ``bfs``
or ``sssp``, the accepted cells present, each pair of configuration and mix
once, each cell's kernel metric reported), and run the faults of
``correct`` on every one-chip cell; a four-chip cell brings its own, the
exchange between chips left out among them.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
#: The weight scheme of a configuration that names none.
DEFAULT_WEIGHTS = "hash_int"


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: tuple | None     # None: every cell
    layer: str | None = None
    moves: str | None = None
    bound: float | None = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    why: str


class Benchmark:
    """``BENCHMARK.json`` at ``root``, with the benchmark folder beside it."""

    def __init__(self, root: Path):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.doc = json.load(f)
        self.bench_dir = self.root / self.doc["paths"][0]
        self.config_files = {c["name"]: c["file"] for c in self.doc["configs"]}
        self.cells = {w["name"]: Cell(w["name"], w["config"], w["traffic"],
                                      int(w["chips"]), w["why"])
                      for w in self.doc["workloads"]}
        self.end_to_end = [_metric(m) for m in self.doc["end_to_end"]]
        self.per_layer = [_metric(m) for m in self.doc["per_layer"]]

    def cell(self, name: str) -> Cell:
        if name not in self.cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                           f"{sorted(self.cells)}")
        return self.cells[name]

    def config(self, name: str) -> dict:
        if name not in self.config_files:
            raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
        path = (self.root / self.config_files[name]).resolve()
        if (self.bench_dir / "configs").resolve() not in path.parents:
            raise ValueError(f"{path} lies outside {self.bench_dir / 'configs'}")
        return _load_json(path)

    def traffic(self, name: str) -> dict:
        return _load_json(self.bench_dir / "traffic" / f"{_checked(name)}.json")

    def kind(self, name: str):
        """The module ``portbench/traffic/<name>.py`` of a traffic kind."""
        return _module(self.bench_dir / "traffic" / f"{_checked(name)}.py",
                       "portbench_traffic_" + name)

    def weights(self, name: str | None = None):
        """The module ``portbench/weights/<name>.py`` of a weight scheme;
        ``hash_int`` when ``name`` is None."""
        name = DEFAULT_WEIGHTS if name is None else name
        return _module(self.bench_dir / "weights" / f"{_checked(name)}.py",
                       "portbench_weights_" + name)

    def metrics_for(self, cell: str, trace: bool) -> list[Metric]:
        ms = self.per_layer if trace else self.end_to_end
        return [m for m in ms if m.applies_to(cell)]

    def reader(self, metric: str):
        """The ``read(ctx)`` function of ``portbench/metrics/<metric>.py``."""
        return _module(self.bench_dir / "metrics" / f"{_checked(metric)}.py",
                       "portbench_metric_" + metric).read


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metric(m: dict) -> Metric:
    w = m.get("workloads")
    return Metric(m["name"], m["unit"], m["better"], m["source"],
                  None if w is None else tuple(w), m.get("layer"), m.get("moves"),
                  m.get("bound"))


def _checked(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)
