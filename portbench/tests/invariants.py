"""The benchmark's invariants, as functions of the root of a checkout that
holds ``BENCHMARK.json`` and the benchmark folder.

Each invariant returns the problems it finds, ``[]`` where it holds.  They
speak of whatever cells the benchmark holds and name none but the accepted
ones, which may only be retired by a change to the benchmark itself, so a
cell, configuration, traffic mix, per-layer metric or weight scheme is added
as new files and new entries (with the new cell's name appended to the
``workloads`` lists of the metrics it reports) and no test changes.
:func:`edits` tells such an addition from an edit of ``BENCHMARK.json``.
"""
from __future__ import annotations

from portbench.bench.spec import Benchmark

#: The cells of the accepted benchmark.
ACCEPTED_CELLS = ("bfs-spec-s22", "sssp-spec-s22")
KERNELS = ("bfs", "sssp")
MAX_CELLS = 24
CHIPS = (1, 4)


def kernel_of(bench: Benchmark, cell: str) -> str:
    """The Graph500 kernel of a cell's configuration."""
    return bench.config(bench.cell(cell).config)["kernel"]


def kernel_metric(bench: Benchmark, cell: str) -> str:
    """The end-to-end metric a cell's kernel is ranked by: ``<kernel>_gteps``."""
    return kernel_of(bench, cell) + "_gteps"


def one_chip_cells(root) -> list:
    return [c.name for c in Benchmark(root).cells.values() if c.chips == 1]


def found_by_name(root) -> list:
    """Every configuration, traffic mix, traffic kind and reader is found by
    its name (a missing one raises, naming its file), and a configuration
    gives the source's value of each key it reduces."""
    b, out = Benchmark(root), []
    for c in b.doc["configs"]:
        doc = b.config(c["name"])
        out += [f"configuration {c['name']}: reduced {k!r} has no reduced_from entry"
                for k in c["reduced"] if k not in doc.get("reduced_from", {})]
    for cell in b.cells.values():
        b.config(cell.config)
        kind = b.kind(b.traffic(cell.traffic)["kind"])
        if not (callable(getattr(kind, "warm", None)) and callable(getattr(kind, "window", None))):
            out.append(f"cell {cell.name}: its traffic kind lacks warm or window")
    out += [f"metric {m.name}: read is not callable"
            for m in b.end_to_end + b.per_layer if not callable(b.reader(m.name))]
    return out


def cell_count(root) -> list:
    n = len(Benchmark(root).cells)
    return [] if 1 <= n <= MAX_CELLS else [f"{n} cells, not 1 to {MAX_CELLS}"]


def chips(root) -> list:
    """Each cell takes 1 or 4 chips, and at most a quarter of the cells,
    rounded down, or one, take 4."""
    cells = Benchmark(root).cells.values()
    out = [f"cell {c.name}: {c.chips} chips" for c in cells if c.chips not in CHIPS]
    four = sum(c.chips == 4 for c in cells)
    allowed = max(1, len(cells) // 4)
    if four > allowed:
        out.append(f"{four} four-chip cells of {len(cells)}, at most {allowed}")
    return out


def kernels(root) -> list:
    b = Benchmark(root)
    return [f"configuration {name}: kernel {b.config(name).get('kernel')!r}"
            for name in b.config_files if b.config(name).get("kernel") not in KERNELS]


def accepted_cells(root) -> list:
    cells = Benchmark(root).cells
    return [f"accepted cell {c} is gone" for c in ACCEPTED_CELLS if c not in cells]


def pairs(root) -> list:
    """A pair of configuration and traffic mix appears once."""
    seen, out = {}, []
    for c in Benchmark(root).cells.values():
        key = (c.config, c.traffic)
        if key in seen:
            out.append(f"cells {seen[key]} and {c.name} both run {key}")
        seen.setdefault(key, c.name)
    return out


def reports(root) -> list:
    """Every cell reports ``setup_s``, its kernel's end-to-end metric, and a
    per-layer metric."""
    b, out = Benchmark(root), []
    for cell in b.cells:
        e2e = {m.name for m in b.metrics_for(cell, trace=False)}
        for name in ("setup_s", kernel_metric(b, cell)):
            if name not in e2e:
                out.append(f"cell {cell}: reports no {name}")
        if not b.metrics_for(cell, trace=True):
            out.append(f"cell {cell}: reports no per-layer metric")
    return out


INVARIANTS = (found_by_name, cell_count, chips, kernels, accepted_cells, pairs, reports)


def problems(root) -> list:
    return [p for check in INVARIANTS for p in check(root)]


def edits(old, new, at: str = "") -> list:
    """Where ``new`` departs from ``old`` by more than entries appended to
    lists: a value changed, a key added or removed, an item changed or
    taken out.  ``[]`` for ``BENCHMARK.json`` with new cells, configurations
    and metrics appended, and new names appended to ``workloads`` lists."""
    if isinstance(old, dict) and isinstance(new, dict):
        out = [f"{at}/{k}: {'removed' if k in old else 'added'}"
               for k in sorted(set(old) ^ set(new))]
        for k in sorted(set(old) & set(new)):
            out += edits(old[k], new[k], f"{at}/{k}")
        return out
    if isinstance(old, list) and isinstance(new, list):
        if len(new) < len(old):
            return [f"{at}: {len(old) - len(new)} items taken out"]
        return [p for i, (a, b) in enumerate(zip(old, new))
                for p in edits(a, b, f"{at}/{i}")]
    return [] if type(old) is type(new) and old == new else [f"{at}: {old!r} -> {new!r}"]

