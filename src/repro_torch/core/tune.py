"""Plan auto-tuner: sweep the ``compile_plan`` search space, persist
per-scale winners (DESIGN.md §11).

Counterpart of ``repro.core.tune`` with its names, budgets, enumeration,
acceptance rule, ranking and table layout.  The paper tunes its
hybrid-BFS knobs (direction-switch α/β, chunking, exchange wiring, mesh
layout) by hand per machine scale (§4.2/§4.3); the frozen
:class:`~repro_torch.core.plan.BFSPlan` makes them declarative axes, so
tuning is a loop over :func:`~repro_torch.core.plan.compile_plan`:

  1. **enumerate** — :func:`enumerate_plans` builds the candidate set for
     a device count under a :class:`TuneBudget`, exactly as the JAX
     package does (1 / 4 / 12 candidates under small / medium / full on
     one device: α/β × ``n_chunks`` of ``layout=()``).
  2. **compile**  — each candidate goes through ``compile_plan``; a
     ``ValueError`` (too few devices, a non-power-of-two member axis) is
     recorded as *skipped*.  A mesh layout that fits the visible devices
     compiles over them and is swept (on one device: the 1-shard root
     mesh).
  3. **accept**   — a candidate's parents must be bitwise identical to the
     single-device batched bitmap plan's on the shared inputs before it is
     timed; divergence marks it *rejected*.
  4. **time**     — min-of-``reps`` host clock of the batched traversal,
     synchronised before the clock starts and before it stops; accepted
     candidates rank by per-root time, ties broken on the plan's JSON.
  5. **persist**  — :func:`save_tuned` merges the winner into the port's
     own schema-versioned table ``TUNED_PLANS_torch.json`` (environment
     override ``REPRO_TORCH_TUNED_PLANS``), keyed
     ``scale{S}/dev{P}/{backend}`` with ``backend`` ``cuda`` or ``cpu``;
     :func:`tuned_plan` is the lookup that ``Graph500Config(tuned=True)``
     and the serving engine consume.  The layout is the JAX table's, so
     each package reads a table the other wrote.

CLI::

    PYTHONPATH=src python -m repro_torch.core.tune --scale 20 --budget full

runs on the card (``--device cpu`` for the plain versions) and fails
(exit 1) unless the winner table is non-empty and the winner passed the
bitwise acceptance.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.comms.topology import plan_device_mesh
from repro_torch.core.bfs_steps import edge_view
from repro_torch.core.graph_build import build_csr
from repro_torch.core.heavy import build_heavy_core
from repro_torch.core.kernels import rekernel_plan
from repro_torch.core.kronecker import EdgeList, generate_edges, sample_roots
from repro_torch.core.plan import (
    BFSPlan, PreparedGraph, compile_plan, visible_devices,
)
from repro_torch.core.reorder import degree_reorder, relabel_edges
from repro_torch.core.teps import batch_harmonic_mean_teps
from repro_torch.util import resolve_device

# v2: BFSPlan grew the `partition` axis; v1 winners predate it and must be
# re-swept, not silently reinterpreted.
SCHEMA_VERSION = 2

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_TABLE = os.path.join(_REPO_ROOT, "TUNED_PLANS_torch.json")
TABLE_ENV = "REPRO_TORCH_TUNED_PLANS"

def table_path(path: Optional[str] = None) -> str:
    """Resolve the tuned-plan table path: explicit arg, then the
    ``REPRO_TORCH_TUNED_PLANS`` env override, then
    ``TUNED_PLANS_torch.json`` at the repo root."""
    return path or os.environ.get(TABLE_ENV) or DEFAULT_TABLE


def device_view(device=None) -> tuple[int, str]:
    """``(n_devices, backend)`` of the table key for plans on ``device``
    (None: the card): the visible cards and ``"cuda"``, or 1 and
    ``"cpu"``.  A lookup, so it never raises for a missing card."""
    dev = torch.device("cuda" if device is None else device)
    return visible_devices(dev), dev.type


# ---------------------------------------------------------------------------
# Budgets + search-space enumeration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TuneBudget:
    """How much of the plan space a sweep explores (and how carefully it
    times).  ``small`` is the CI smoke: canonical layouts only, default
    α/β, 2 reps.  ``full`` crosses every axis."""

    name: str
    exchanges: tuple = ("hier_or",)
    partitions: tuple = ("block", "word_cyclic")
    alpha_beta: tuple = ((14.0, 24.0),)
    n_chunks: tuple = (64,)
    all_factorizations: bool = False
    n_roots: int = 4
    reps: int = 2


BUDGETS = {
    "small": TuneBudget(
        "small", exchanges=("hier_or", "hier_or_packed", "hier_or_sieve")),
    "medium": TuneBudget(
        "medium",
        exchanges=("hier_or", "hier_gather", "hier_or_packed",
                   "hier_or_sieve"),
        alpha_beta=((8.0, 64.0), (14.0, 24.0)), n_chunks=(16, 64),
        all_factorizations=True, n_roots=8, reps=2),
    "full": TuneBudget(
        "full",
        exchanges=("hier_or", "hier_gather", "flat", "hier_or_packed",
                   "hier_or_sieve"),
        alpha_beta=((8.0, 24.0), (8.0, 64.0), (14.0, 24.0), (14.0, 64.0)),
        n_chunks=(16, 64, 256), all_factorizations=True, n_roots=16, reps=3),
}


def _pow2s_upto(n: int) -> list:
    return [1 << i for i in range(n.bit_length()) if (1 << i) <= n]


def _layout_shapes(n_devices: int, budget: TuneBudget) -> list:
    """(layout, mesh_shape) candidates for ``n_devices`` devices.

    ``small`` keeps the canonical points: the single-device baseline, the
    root-parallel ladder over power-of-two device counts, the topology
    planner's (group, member) split, and the composed 3-axis shapes with
    a 2-way root split.  ``all_factorizations`` (medium/full) adds every
    factorization of the full device count onto each layout, the invalid
    ones (non-pow2 member) included: the sweep records those as skipped.
    """
    out = [((), None)]
    for r in _pow2s_upto(n_devices):
        if r > 1:
            out.append((("root",), (r,)))
    if n_devices > 1:
        planned = plan_device_mesh(n_devices)
        shapes = {planned}
        if budget.all_factorizations:
            shapes |= {(g, n_devices // g)
                       for g in range(1, n_devices + 1) if n_devices % g == 0}
        for g, m in sorted(shapes):
            if g * m > 1:
                out.append((("group", "member"), (g, m)))
        composed = set()
        for r in ([2] if not budget.all_factorizations
                  else [d for d in range(2, n_devices) if n_devices % d == 0]):
            rest = n_devices // r
            if rest < 2:
                continue
            groups = ({g for g in range(1, rest + 1) if rest % g == 0}
                      if budget.all_factorizations
                      else {plan_device_mesh(rest)[0], rest // 2 or 1})
            for g in groups:
                if rest % g == 0:
                    composed.add((r, g, rest // g))
        for shape in sorted(composed):
            out.append((("root", "group", "member"), shape))
    return out


def enumerate_plans(n_devices: int, budget: TuneBudget) -> list:
    """The declarative candidate set: layouts × exchange × partition ×
    α/β × n_chunks, deduplicated (exchange and partition only vary where
    a member axis exists)."""
    plans: dict = {}
    for (layout, shape) in _layout_shapes(n_devices, budget):
        vertexy = "member" in layout
        exchanges = budget.exchanges if vertexy else ("hier_or",)
        partitions = budget.partitions if vertexy else ("block",)
        for exchange, partition, (alpha, beta), n_chunks in itertools.product(
                exchanges, partitions, budget.alpha_beta, budget.n_chunks):
            p = BFSPlan(layout=layout, mesh_shape=shape, exchange=exchange,
                        partition=partition, alpha=alpha, beta=beta,
                        n_chunks=n_chunks, batch_roots=True)
            plans[p] = None
    return list(plans)


# ---------------------------------------------------------------------------
# Sweep
# ---------------------------------------------------------------------------

@dataclass
class TuneResult:
    """One candidate's outcome. ``status``: ``ok`` (accepted + timed),
    ``skipped`` (compile_plan refused it), ``rejected`` (parents diverged
    from the single-device oracle — never ranked), ``failed`` (the
    measurement itself raised — recorded with the exception string so
    one crashing candidate never kills the sweep)."""

    plan: BFSPlan
    status: str
    reason: str = ""
    wall_s: float = math.inf
    per_root_us: float = math.inf
    harmonic_mean_teps: float = 0.0
    identical: Optional[bool] = None

    def to_dict(self) -> dict:
        d = {"plan": self.plan.to_dict(), "status": self.status}
        if self.status == "ok":
            d.update(per_root_us=self.per_root_us, wall_us=self.wall_s * 1e6,
                     harmonic_mean_teps=self.harmonic_mean_teps,
                     identical=self.identical)
        else:
            d["reason"] = self.reason
        return d


@dataclass
class TuneReport:
    """Ranked sweep output: ``results`` holds accepted candidates fastest
    first; ``skipped`` the invalid/rejected ones with their reasons.
    ``interpret_mode`` is True when the kernels' plain versions ran (on
    the CPU)."""

    scale: int
    n_devices: int
    backend: str
    interpret_mode: bool
    budget: str
    seed: int
    n_roots: int
    reps: int
    results: list = field(default_factory=list)
    skipped: list = field(default_factory=list)

    @property
    def winner(self) -> Optional[TuneResult]:
        return self.results[0] if self.results else None

    def table(self) -> str:
        """The ranked winner table, one row per candidate."""
        lines = [f"# tune scale={self.scale} devices={self.n_devices} "
                 f"backend={self.backend} budget={self.budget} "
                 f"roots={self.n_roots} reps={self.reps} "
                 f"interpret={self.interpret_mode}",
                 "rank,layout,mesh,exchange,partition,alpha,beta,n_chunks,"
                 "per_root_us,hmean_teps,rel_vs_best,identical"]
        best = self.results[0].per_root_us if self.results else None
        for i, r in enumerate(self.results):
            p = r.plan
            mesh = "x".join(map(str, p.mesh_shape)) if p.mesh_shape else "1"
            layout = "*".join(p.layout) if p.layout else "single"
            lines.append(
                f"{i + 1},{layout},{mesh},{p.exchange},{p.partition},"
                f"{p.alpha:g},{p.beta:g},{p.n_chunks},{r.per_root_us:.0f},"
                f"{r.harmonic_mean_teps:.3g},{r.per_root_us / best:.3f},"
                f"{r.identical}")
        for r in self.skipped:
            p = r.plan
            mesh = "x".join(map(str, p.mesh_shape)) if p.mesh_shape else "1"
            lines.append(f"-,{'*'.join(p.layout) or 'single'},{mesh},"
                         f"{p.exchange},{p.partition},,,,"
                         f"{r.status}:{r.reason[:60]},,,")
        return "\n".join(lines)


def _plan_sort_key(plan: BFSPlan) -> str:
    return json.dumps(plan.to_dict(), sort_keys=True)


def _build_inputs(scale: int, seed: int, edge_factor: int, n_roots: int,
                  device, edges: Optional[EdgeList] = None, roots=None):
    """Shared Kronecker inputs on ``device``: one degree-sorted graph +
    root sample reused by every candidate (and by the oracle).

    ``edges`` replaces the generated edge list and ``roots`` the sampled
    roots (ids in the edge list's labels), as ``pipeline.build`` and
    ``pipeline.run`` take them: the two packages' generators differ, so
    parity runs feed the JAX package's."""
    device = resolve_device(device)
    if edges is None:
        edges = generate_edges(seed, scale, edge_factor, device=device)
    elif edges.src.device.type != device.type:
        raise ValueError(f"edges lie on {edges.src.device}, the sweep runs "
                         f"on {device}")
    g0 = build_csr(edges)
    r = degree_reorder(g0.degree)
    del g0
    g = build_csr(relabel_edges(edges, r))
    core = build_heavy_core(g, threshold=100 if scale >= 13 else 8)
    ev = edge_view(g)
    if roots is None:
        roots = sample_roots(seed, edges, n_roots)
    if not isinstance(roots, torch.Tensor):
        roots = torch.from_numpy(np.array(roots, dtype=np.int64))
    roots = r.new_from_old[roots.to(device).long()].cpu().numpy().astype(np.int32)
    pg = PreparedGraph(ev=ev, degree=g.degree, core=core)
    return pg, g.degree, roots, g.num_vertices


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _default_measure(compiled, roots, reps: int) -> float:
    """min-of-``reps`` host clock of the batched traversal, the device
    synchronised before the clock starts and before it stops (the parity
    pass already built and loaded the kernels)."""
    wall = math.inf
    for _ in range(reps):
        _sync(compiled.device)
        t0 = time.perf_counter()
        compiled.bfs(roots)
        _sync(compiled.device)
        wall = min(wall, time.perf_counter() - t0)
    return wall


def _evaluate(plan: BFSPlan, pg: PreparedGraph, roots: np.ndarray, v: int,
              degree: torch.Tensor, oracle_parent: torch.Tensor,
              measure: Callable, reps: int, device) -> TuneResult:
    """Compile, accept and time one candidate.  Its ``CompiledBFS`` (with
    the edge view chunked for its ``n_chunks``) is released on return."""
    try:
        compiled = compile_plan(plan, pg, device=device)
    except ValueError as e:
        return TuneResult(plan, "skipped", reason=str(e))
    parent = compiled.bfs(roots).parent[:, :v]   # parity pass doubles as warmup
    if not torch.equal(parent, oracle_parent):
        return TuneResult(
            plan, "rejected",
            reason="parents diverge from the single-device bitmap "
                   "engine — acceptance rule (DESIGN.md §11)")
    try:
        wall = measure(compiled, roots, reps)
    except Exception as e:   # a crashing candidate must not kill the sweep
        return TuneResult(plan, "failed",
                          reason=f"measurement raised {type(e).__name__}: {e}")
    per_root = wall / len(roots)
    return TuneResult(
        plan, "ok", wall_s=wall, per_root_us=per_root * 1e6,
        harmonic_mean_teps=batch_harmonic_mean_teps(degree, parent, per_root),
        identical=True)


def sweep(
    scale: int,
    *,
    budget="small",
    seed: int = 1,
    edge_factor: int = 16,
    n_roots: Optional[int] = None,
    reps: Optional[int] = None,
    plans: Optional[list] = None,
    measure: Optional[Callable] = None,
    log: Callable = lambda s: print(s, file=sys.stderr, flush=True),
    device=None,
    edges: Optional[EdgeList] = None,
    roots=None,
) -> TuneReport:
    """Run the sweep on ``device`` (None: the card) and return the ranked
    report.

    ``plans`` overrides the enumerated candidate set; ``measure`` swaps
    the clock for a deterministic cost model
    (``measure(compiled, roots, reps) -> seconds``).  ``edges``/``roots``
    replace the generated graph and sampled roots (see
    :func:`_build_inputs`).
    """
    if isinstance(budget, str):
        budget = BUDGETS[budget]
    n_roots = budget.n_roots if n_roots is None else n_roots
    reps = budget.reps if reps is None else reps
    measure = measure or _default_measure
    dev = resolve_device(device)
    n_devices = visible_devices(dev)

    pg, degree, roots, v = _build_inputs(scale, seed, edge_factor, n_roots,
                                         dev, edges=edges, roots=roots)
    if plans is None:
        plans = enumerate_plans(n_devices, budget)
    report = TuneReport(
        scale=scale, n_devices=n_devices, backend=dev.type,
        interpret_mode=dev.type == "cpu", budget=budget.name, seed=seed,
        n_roots=len(roots), reps=reps)

    # The acceptance oracle: the single-device batched bitmap plan on the
    # same inputs.  One oracle covers every candidate because the
    # scatter-min parent convention makes the tree direction-invariant:
    # α/β only move the switch level, never the winning parent.
    oracle_parent = compile_plan(BFSPlan(layout=(), batch_roots=True), pg,
                                 device=dev).bfs(roots).parent

    for plan in plans:
        key = _plan_sort_key(plan)
        res = _evaluate(plan, pg, roots, v, degree, oracle_parent, measure,
                        reps, dev)
        if res.status == "ok":
            report.results.append(res)
            log(f"# ok   {key}: per_root={res.per_root_us:.0f}us")
        else:
            report.skipped.append(res)
            log(f"# {res.status} {key}: {res.reason}")
    report.results.sort(
        key=lambda r: (r.per_root_us, _plan_sort_key(r.plan)))
    return report


# ---------------------------------------------------------------------------
# Persistence: TUNED_PLANS_torch.json
# ---------------------------------------------------------------------------

def _entry_key(scale: int, n_devices: int, backend: str) -> str:
    return f"scale{scale}/dev{n_devices}/{backend}"


def load_table(path: Optional[str] = None) -> Optional[dict]:
    """Load the tuned-plan table, or None when the file doesn't exist.
    A schema_version other than :data:`SCHEMA_VERSION` is a ValueError —
    a future-format table must be re-tuned, not half-read."""
    path = table_path(path)
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return None
    got = doc.get("schema_version")
    if got != SCHEMA_VERSION:
        hint = ("its plans predate the BFSPlan `partition` axis (v2) and "
                "the sweep must re-rank both partitions"
                if isinstance(got, int) and got < SCHEMA_VERSION
                else "it was written by a newer plan schema")
        raise ValueError(
            f"{path}: schema_version {got!r} != supported {SCHEMA_VERSION} — "
            f"{hint}; delete the file (or entry) and re-run "
            f"`python -m repro_torch.core.tune --budget small --scale <N> "
            f"--device <cuda|cpu>` to regenerate")
    return doc


def save_tuned(report: TuneReport, path: Optional[str] = None,
               top: int = 8) -> str:
    """Merge the report's winner into the versioned table (other keys'
    entries are preserved) and return the path written.  A
    foreign-schema table propagates ``load_table``'s ValueError rather
    than being clobbered — delete the file to regenerate deliberately."""
    if report.winner is None:
        raise ValueError("cannot persist a sweep with no accepted winner")
    path = table_path(path)
    doc = load_table(path)
    if doc is None:
        doc = {"schema_version": SCHEMA_VERSION, "entries": {}}
    key = _entry_key(report.scale, report.n_devices, report.backend)
    doc["entries"][key] = {
        "scale": report.scale,
        "n_devices": report.n_devices,
        "backend": report.backend,
        "interpret_mode": report.interpret_mode,
        "budget": report.budget,
        "seed": report.seed,
        "n_roots": report.n_roots,
        "reps": report.reps,
        "created_unix": int(time.time()),
        "plan": report.winner.plan.to_dict(),
        "per_root_us": report.winner.per_root_us,
        "harmonic_mean_teps": report.winner.harmonic_mean_teps,
        "identical": report.winner.identical,
        "ranked": [r.to_dict() for r in report.results[:top]],
        "n_skipped": len(report.skipped),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def tuned_plan(
    scale: int,
    n_devices: Optional[int] = None,
    backend: Optional[str] = None,
    *,
    path: Optional[str] = None,
    overrides: Optional[dict] = None,
    kernel: Optional[str] = None,
) -> Optional[BFSPlan]:
    """Look up the persisted winner for ``(scale, n_devices, backend)``.

    ``n_devices``/``backend`` default to the card's :func:`device_view`.
    Returns ``None`` when the table is missing or holds no matching entry
    — callers fall back to their own defaults.  ``overrides`` replaces
    explicit plan fields on top of the table entry (explicit always wins
    over tuned).  ``kernel`` retargets the winner at another kernel via
    :func:`repro_torch.core.kernels.rekernel_plan`."""
    doc = load_table(path)
    if doc is None:
        return None
    if n_devices is None or backend is None:
        n_view, b_view = device_view()
        n_devices = n_view if n_devices is None else n_devices
        backend = b_view if backend is None else backend
    entry = doc["entries"].get(_entry_key(scale, n_devices, backend))
    if entry is None:
        return None
    plan = BFSPlan.from_dict(entry["plan"])
    if overrides:
        plan = dataclasses.replace(plan, **overrides)
    if kernel is not None:
        plan = rekernel_plan(plan, kernel)
    return plan


def tuned_exchange(scale: int, n_devices: Optional[int] = None,
                   backend: Optional[str] = None,
                   path: Optional[str] = None) -> tuple:
    """Best-effort exchange wiring for a modelled machine: an exact
    ``(scale, n_devices)`` entry if present (matching ``backend`` too when
    given), else the nearest-scale entry in the table, else the
    ``hier_or`` default.  Returns ``(exchange, source_tag)``."""
    try:
        doc = load_table(path)
    except ValueError:
        doc = None
    if doc is None or not doc.get("entries"):
        return "hier_or", "default"
    entries = sorted(doc["entries"].items())
    if n_devices is not None:
        exact = [(k, e) for k, e in entries
                 if e["scale"] == scale and e["n_devices"] == n_devices
                 and (backend is None or e["backend"] == backend)]
        if exact:
            key, entry = exact[0]
            return entry["plan"].get("exchange", "hier_or"), f"tuned:{key}"
    key, entry = min(entries, key=lambda kv: (abs(kv[1]["scale"] - scale),
                                              kv[1]["scale"], kv[0]))
    return (entry["plan"].get("exchange", "hier_or"),
            f"tuned:nearest_scale{entry['scale']}")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="BFSPlan auto-tuner (DESIGN.md §11)")
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--budget", choices=sorted(BUDGETS), default="small")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--roots", type=int, default=None,
                    help="override the budget's root-sample size")
    ap.add_argument("--reps", type=int, default=None,
                    help="override the budget's min-of-k rep count")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--out", default=None,
                    help=f"table to update (default {DEFAULT_TABLE}, "
                         f"{TABLE_ENV} overrides)")
    ap.add_argument("--no-save", action="store_true",
                    help="print the ranked table without persisting")
    args = ap.parse_args(argv)

    report = sweep(args.scale, budget=args.budget, seed=args.seed,
                   n_roots=args.roots, reps=args.reps, device=args.device)
    print(report.table(), flush=True)
    if report.winner is None:
        print("# FAIL: no candidate was accepted (empty winner table)",
              file=sys.stderr)
        return 1
    if not report.winner.identical:
        print("# FAIL: winner is not bitwise-identical to the "
              "single-device engine", file=sys.stderr)
        return 1
    if not args.no_save:
        path = save_tuned(report, args.out)
        print(f"# wrote {path} "
              f"[{_entry_key(report.scale, report.n_devices, report.backend)}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
