"""One run of one cell: set up, warm up, measure, compare, report.

Set-up generates the timed graph and its search keys from the
configuration's ``graph_seed`` (:mod:`portbench.bench.inputs`), hands the
edge list to the program's Graph500 step 2 (``pipeline.build``: CSR, degree
sort, heavy core, weights) and compiles the configuration's pinned plan
(``compile_plan``).  An SSSP configuration's weight scheme
(``portbench/weights/<scheme>.py``) adds its knobs to the program's
configuration and gives the reference its weights.  The cell's traffic kind
(``portbench/traffic/<kind>.py``, named by the mix's ``kind``) warms up and
then drives the window: it calls the program through a :class:`Recorder`,
which times each call alone on the host clock, ended by a device
synchronisation, counts each answer's traversed edges after its clock stops,
and keeps a sample of the answers drawn from the seed.  With ``trace`` the
window is the mix's first ``trace_searches`` calls under ``torch.profiler``,
for the per-layer metrics, which also read the program's counters over it.

After the window: the window's peak device memory is read, the program's
state is freed, and the reference (:mod:`portbench.bench.compare`) checks
the built graph, every answer's edge count and key, and the sample.  Then
the program builds the checked graph, drawn from the run's seed, the same
kind drives ``checked_searches`` calls on it, and the reference checks
every answer: every seed checks a graph of its own.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import math
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from portbench.bench import compare, inputs, roofline, trace as tracemod
from portbench.bench.spec import Benchmark
from portbench.bench.teps import traversed_edges

#: Top-level module names that no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CHECK_STREAM = 0x636B          # the checked sample's stream


class NoChip(RuntimeError):
    """The machine lacks the cards the cell asks for."""


@dataclass
class Context:
    """What a metric reader (``portbench/metrics/<name>.py``) reads."""

    kernel: str
    setup_s: float
    times_s: list                                   # each call's seconds
    edges: list                                     # each answer's traversed edges
    construction_s: float
    levels: list = field(default_factory=list)      # traced answers' levels / rounds
    trace: tracemod.Trace | None = None
    core_outputs: list = field(default_factory=list)  # traced core_spmv outputs
    core_words: int = 0
    bitmap_words: int = 0
    num_vertices: int = 0
    counters: dict = field(default_factory=dict)    # the program's, over the traced window


@dataclass
class Program:
    """What a traffic kind drives: the program's configuration, built graph
    and compiled plan, and the keys as ids of the built graph."""

    cfg: object
    built: object
    compiled: object
    roots: list


class Recorder:
    """What a traffic kind reports each call of the window to.

    ``call(keys, fn)`` times ``fn()``, which returns one answer (with
    ``parent``, ``level`` and ``stats``) for each key index in ``keys``;
    ``more()`` is false once the window's time or its count of calls is
    spent."""

    def __init__(self, dev, degree, seconds: float, limit: int | None,
                 n_check: int, seed: int, trace: bool, roots: list):
        self.dev, self.degree, self.roots = dev, degree, roots
        self.seconds, self.limit, self.n_check = seconds, limit, n_check
        self.rng = random.Random(int(seed) ^ CHECK_STREAM)
        self.trace = trace
        self.times, self.keys, self.edges, self.at_root = [], [], [], []
        self.levels, self.checked = [], []
        self.w0 = self.last = None

    def more(self) -> bool:
        if self.w0 is None:
            _sync(self.dev)
            self.w0 = self.last = time.perf_counter()
            return True
        return (self.last - self.w0 < self.seconds
                and (self.limit is None or len(self.times) < self.limit))

    def call(self, keys: list, fn) -> None:
        _sync(self.dev)                 # the last answer's edge count ends off the clock
        with _span(self.trace):
            t0 = time.perf_counter()
            answers = fn()
            _sync(self.dev)
            t1 = time.perf_counter()
        self.times.append(t1 - t0)
        self.last = t1
        if len(answers) != len(keys):
            raise ValueError(f"{len(answers)} answers to {len(keys)} keys")
        for k, res in zip(keys, answers):
            i = len(self.keys)
            self.keys.append(k)
            self.edges.append(traversed_edges(self.degree, res.parent))
            r = self.roots[k]
            self.at_root.append(torch.stack([res.parent[r].long(), res.level[r].long()]))
            if self.trace:
                self.levels.append(res.stats.levels)
            # a uniform sample of the window's answers (reservoir), from the seed
            if len(self.checked) < self.n_check:
                self.checked.append((i, k, res.parent, res.level))
            else:
                j = self.rng.randrange(i + 1)
                if j < self.n_check:
                    self.checked[j] = (i, k, res.parent, res.level)


def _span(trace: bool):
    if not trace:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(tracemod.SEARCH_SPAN)


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_program(root: Path):
    """The PyTorch port from ``<root>/src``, and nowhere else."""
    src = (Path(root) / "src").resolve()
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    prog = importlib.import_module("repro_torch")
    where = Path(prog.__file__).resolve()
    if src not in where.parents:
        raise ImportError(f"repro_torch was loaded from {where}, not from {src}")
    importlib.import_module("repro_torch.core.pipeline")
    return prog


def program_config(doc: dict, graph_seed: int, device: str, weights):
    """The program's ``Graph500Config`` of a configuration file, on the
    graph drawn from ``graph_seed``; ``weights`` is its weight scheme."""
    from repro_torch.core.pipeline import Graph500Config

    kw = dict(doc["program"])
    rung = kw.pop("rung", None)
    kw.update(scale=doc["scale"], edge_factor=doc["edge_factor"], seed=graph_seed,
              n_roots=doc["search_keys"], kernel=doc["kernel"], device=device)
    if doc["kernel"] == "sssp":
        kw.update(weights.program_kw(doc))
    return Graph500Config.ladder(rung, **kw) if rung else Graph500Config(**kw)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


class _CoreCapture:
    """Keeps each ``core_spmv`` output of the traced window (a reference,
    no copy) for the kernel's byte count."""

    def __init__(self, ops):
        self.ops, self.orig, self.outputs = ops, ops.core_spmv, []

    def __enter__(self):
        def wrapped(*a, **kw):
            out = self.orig(*a, **kw)
            self.outputs.append(out)
            return out
        self.ops.core_spmv = wrapped
        return self

    def __exit__(self, *exc):
        self.ops.core_spmv = self.orig


def _set_up(doc: dict, graph_seed: int, device: str, phases: dict, weights):
    """The program built on the graph drawn from ``graph_seed``, and the
    keys (input labels, on the host); ``phases`` gets the time each step
    ended."""
    from repro_torch.core.kronecker import EdgeList
    from repro_torch.core.pipeline import build, search_keys
    from repro_torch.core.plan import compile_plan

    dev = torch.device(device)
    v = 1 << doc["scale"]
    src, dst = inputs.graph(doc, graph_seed, dev)
    keys = inputs.search_keys(graph_seed, src, dst, v, doc["search_keys"])
    phases["inputs"] = time.perf_counter()
    cfg = program_config(doc, graph_seed, device, weights)
    built = build(cfg, edges=EdgeList(src=src, dst=dst, num_vertices=v))
    del src, dst
    phases["build"] = time.perf_counter()
    compiled = compile_plan(cfg.to_plan(), built, device=device)
    phases["plan"] = time.perf_counter()
    roots = [int(r) for r in search_keys(cfg, built, roots=keys)]
    return Program(cfg, built, compiled, roots), keys.cpu()


def _outputs(prog: Program, rec: Recorder) -> compare.Outputs:
    """What the program produced, for the comparison."""
    ev, nnz = prog.built.ev, prog.built.nnz
    return compare.Outputs(
        nnz=nnz, src=ev.src[:nnz], dst=ev.dst[:nnz], degree=prog.built.degree,
        weight=None if ev.weight is None else ev.weight[:nnz],
        search_keys=list(rec.keys),
        search_edges=[int(m) for m in torch.stack(rec.edges).cpu()] if rec.edges else [],
        checked=rec.checked,
        search_roots=[tuple(x) for x in torch.stack(rec.at_root).cpu().tolist()]
        if rec.at_root else [])


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _check(doc: dict, graph_seed: int, keys, out: compare.Outputs, dev, weights) -> dict:
    """The reference's verdict on ``out``, from the inputs drawn anew."""
    src, dst = inputs.graph(doc, graph_seed, dev)
    inp = compare.Inputs(src=src, dst=dst, num_vertices=1 << doc["scale"],
                         keys=keys.to(dev), kernel=doc["kernel"], seed=graph_seed,
                         weights=weights, doc=doc)
    return compare.compare(out, inp)


def run(root, cell_name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", require_chip: bool = True,
        overrides: dict | None = None) -> tuple[dict, list]:
    """One run; returns the result line's object and the lines that
    compare each checked number with its limit."""
    bench = Benchmark(root)
    cell = bench.cell(cell_name)
    doc = {**bench.config(cell.config), **(overrides or {})}
    mix = bench.traffic(cell.traffic)
    kind = bench.kind(mix["kind"])
    weights = bench.weights(doc.get("weights"))
    if require_chip:
        if not torch.cuda.is_available():
            raise NoChip("no CUDA device: this benchmark runs on the card only")
        if torch.cuda.device_count() < cell.chips:
            raise NoChip(f"{torch.cuda.device_count()} CUDA devices, the cell "
                         f"asks for {cell.chips}")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    phases = {"start": t_start}
    load_program(root)
    from repro_torch import tracing
    from repro_torch.core.heavy import padded_bitmap_words
    from repro_torch.kernels import ops as kops
    phases["import"] = time.perf_counter()

    # ---- set-up: the inputs, the program's build and plan, the warm-up ----
    prog, keys = _set_up(doc, doc["graph_seed"], device, phases, weights)
    kind.warm(prog, mix, seed)
    _sync(dev)
    phases["warmup"] = time.perf_counter()
    setup_s = phases["warmup"] - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the window ----
    rec = Recorder(dev, prog.built.degree, seconds,
                   mix["trace_searches"] if trace else None, mix["checked_searches"],
                   seed, trace, prog.roots)
    prof = capture = None
    counted = tracing.counters()
    with contextlib.ExitStack() as stack:
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            prof = stack.enter_context(profile(activities=acts))
            capture = stack.enter_context(_CoreCapture(kops))
        kind.window(prog, mix, seed, rec)
        _sync(dev)
        window_s = time.perf_counter() - rec.w0
    counted = {k: n - counted.get(k, 0) for k, n in tracing.counters().items()}

    # ---- after the window: the peak, then the program's state freed ----
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    out = _outputs(prog, rec)
    core = prog.built.core
    core_words = 0 if core is None else core.k // 32
    bitmap_words = padded_bitmap_words(1 << doc["scale"])
    construction_s = float(prog.built.construction_s)
    times, edges, levels = rec.times, out.search_edges, [int(x) for x in rec.levels]
    del prog, rec, core
    _free(dev)

    t_ref = time.perf_counter()
    res_win = _check(doc, doc["graph_seed"], keys, out, dev, weights)
    del out
    _free(dev)
    ref_s = time.perf_counter() - t_ref

    # ---- the checked graph, drawn from the run's seed ----
    t_seeded = time.perf_counter()
    cseed = inputs.checked_graph_seed(seed)
    prog, ckeys = _set_up(doc, cseed, device, {}, weights)
    rec = Recorder(dev, prog.built.degree, math.inf, mix["checked_searches"], sys.maxsize,
                   seed, False, prog.roots)
    kind.window(prog, mix, seed, rec)
    out = _outputs(prog, rec)
    del prog, rec
    _free(dev)
    res_seeded = _check(doc, cseed, ckeys, out, dev, weights)
    del out
    _free(dev)
    seeded_s = time.perf_counter() - t_seeded

    nums = {**res_win["numbers"],
            **{"seeded_" + k: x for k, x in res_seeded["numbers"].items()}}
    limits = {**compare.LIMITS, **{"seeded_" + k: x for k, x in compare.LIMITS.items()}}
    ok = (all(nums[k] <= lim for k, lim in limits.items())
          and res_win["checked"] > 0 and res_seeded["checked"] > 0)

    ctx = Context(kernel=doc["kernel"], setup_s=setup_s, times_s=times, edges=edges,
                  construction_s=construction_s, levels=levels,
                  core_words=core_words, bitmap_words=bitmap_words,
                  num_vertices=1 << doc["scale"], counters=counted)
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": len(edges) + res_seeded["answers"],
              "failed": int(res_win["failed"] + res_seeded["failed"])}
    if trace:
        ctx.trace = tracemod.from_profiler(prof)
        ctx.core_outputs = capture.outputs
        if ctx.trace is not None:
            device_info["busy_s"] = tracemod.busy_us(ctx.trace) / 1e6
            device_info["window_s"] = ctx.trace.window_s
    metrics = {}
    for m in bench.metrics_for(cell.name, trace):
        value = bench.reader(m.name)(ctx)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    result["metrics"] = metrics
    device_info["power"] = power_limit() if on_card else "cpu"
    result["device"] = device_info
    if trace and ctx.trace is not None:
        result["breakdown"] = tracemod.breakdown(ctx.trace)
    result["checks"] = {k: {"value": nums[k], "limit": limits[k]} for k in limits}

    marks = list(phases.items())
    lines = ["set-up s: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                                      for a, b in zip(marks, marks[1:]))
             + f"; reference s: {ref_s:.3f}; checked graph s: {seeded_s:.3f}",
             f"memory peak bytes: set-up {setup_peak}, window {peak}"]
    ms = sorted(t * 1e3 for t in times)
    tenth = max(1, len(times) // 10)
    lines.append(f"call ms: min {ms[0]:.3f}, median {ms[len(ms) // 2]:.3f}, "
                 f"max {ms[-1]:.3f}; mean of the first tenth "
                 f"{1e3 * sum(times[:tenth]) / tenth:.3f}, of the last "
                 f"{1e3 * sum(times[-tenth:]) / tenth:.3f}")
    key_edges = {}
    for m in res_win["key_edges"]:
        key_edges[m] = key_edges.get(m, 0) + 1
    lines.append(f"keys by the traversed edges of their component: {key_edges}")
    if trace and ctx.trace is not None:
        for frag in ("core_spmv", "frontier_update", "sssp_relax"):
            us, n = tracemod.kernel_time(ctx.trace, frag)
            if n:
                lines.append(f"{frag}: {n} launches, {us / n:.3f} us each on the device")
        if ctx.core_outputs:
            full = 4 * ctx.core_words * int(ctx.core_outputs[0].numel())
            lines.append(f"core_spmv: {len(ctx.core_outputs)} calls, the bytes their inputs "
                         f"need {roofline.core_spmv_bytes(ctx.core_outputs, core_words):.6e} "
                         f"a call against {full:.6e} for the whole core")
    lines.append(f"window: {len(times)} calls in {window_s:.6f} s, {res_win['checked']} "
                 f"answers checked against the reference; checked graph (seed {cseed}): "
                 f"{res_seeded['checked']} answers; card: {device_info['power']}")
    lines += [f"check {k}: {nums[k]} (limit {limits[k]})" for k in limits]
    return result, lines
