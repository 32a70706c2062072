"""Declarative spec -> plan -> runner API for the single-device BFS.

Counterpart of ``repro.core.plan`` for the slice of it that is ported:

  1. **spec** — :class:`TraversalPlan` (alias ``BFSPlan``), the same frozen
     dataclass with the same fields, ``to_dict``/``from_dict`` and the same
     rejection of unknown fields.
  2. **plan** — :func:`compile_plan` validates the spec, resolves the
     device, prepares the chunked edge view and returns a
     :class:`CompiledBFS`.
  3. **runner** — :meth:`CompiledBFS.run` is the Graph500 timed harness:
     warm-up outside the timed region, spec validation, harmonic-mean TEPS.

Ported: ``layout=()`` with every engine of the BFS kernel (``bitmap``,
``reference``, ``legacy``) and the SSSP kernel (``bitmap``), and ``check``
in off|post|full.  The kernel's row of :mod:`repro_torch.core.kernels`
gives its engines, exchanges, weight needs and validation.  Every other
layout, fault injection and the retry/fallback recovery raise
``NotImplementedError`` naming the ``ROADMAP.md`` queue item that ports
them.  ``batch_roots=True`` (bitmap engine only, as in the JAX package)
runs the roots one after another through the per-root engine and keeps
the batched timing convention (wall-clock / n).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.bfs_steps import (
    DEFAULT_CHUNKS, ChunkedEdgeView, EdgeView, chunk_edge_view,
)
from repro_torch.core.heavy import HeavyCore
from repro_torch.core.hybrid_bfs import (
    MAX_LEVELS, SENTINEL_OK, BFSResult, _run_batch, _run_bitmap_impl,
    _run_legacy, bottom_up_tail, stack_results,
)
from repro_torch.core.kernels import kernel_spec, validate_result_batch
from repro_torch.core.sssp_steps import (
    _run_sssp_batch, _run_sssp_impl, bucket_width, sssp_max_rounds,
)
from repro_torch.core.teps import Graph500Run, traversed_edges
from repro_torch.core.validate import failure_report
from repro_torch.util import resolve_device

VALID_LAYOUTS = (
    (),
    ("root",),
    ("group", "member"),
    ("root", "group", "member"),
)
PARTITIONS = ("block", "word_cyclic")

_TODO = "not ported yet: see ROADMAP.md Queue 1, item"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is {_TODO} '{item}'")


# ---------------------------------------------------------------------------
# 1. Spec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TraversalPlan:
    """Frozen declarative spec of one Graph500 traversal execution (the
    fields of ``repro.core.plan.TraversalPlan``)."""

    engine: str = "bitmap"
    layout: tuple = ()
    mesh_shape: Optional[tuple] = None
    exchange: str = "hier_or"
    partition: str = "block"
    alpha: float = 14.0
    beta: float = 24.0
    max_levels: int = MAX_LEVELS
    n_chunks: int = DEFAULT_CHUNKS
    batch_roots: bool = True
    kernel: str = "bfs"

    def __post_init__(self):
        object.__setattr__(self, "layout", tuple(self.layout))
        if self.mesh_shape is not None:
            object.__setattr__(
                self, "mesh_shape", tuple(int(s) for s in self.mesh_shape))
        if self.kernel == "sssp" and self.exchange == "hier_or":
            object.__setattr__(self, "exchange", "hier_min")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["layout"] = list(self.layout)
        d["mesh_shape"] = (list(self.mesh_shape)
                           if self.mesh_shape is not None else None)
        return d

    @staticmethod
    def from_dict(d: dict) -> "TraversalPlan":
        """Inverse of :meth:`to_dict`; unknown keys are rejected, missing
        keys default-fill."""
        fields = {f.name for f in dataclasses.fields(TraversalPlan)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown BFSPlan fields {sorted(unknown)}; "
                             f"expected a subset of {sorted(fields)}")
        return TraversalPlan(**d)


BFSPlan = TraversalPlan


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def validate_plan(plan: TraversalPlan) -> None:
    """The JAX package's field checks, all ValueErrors, with the engine and
    exchange vocabularies from the plan's kernel row; then the layouts this
    port does not run yet are NotImplementedErrors."""
    spec = kernel_spec(plan.kernel)     # rejects unknown kernels
    if plan.engine not in spec.engines:
        raise ValueError(f"unknown engine {plan.engine!r} for kernel "
                         f"{plan.kernel!r}; expected one of {spec.engines}")
    if plan.layout not in VALID_LAYOUTS:
        raise ValueError(f"unknown layout {plan.layout!r}; expected one of "
                         f"{VALID_LAYOUTS}")
    if plan.exchange not in spec.shard_exchanges:
        raise ValueError(f"unknown exchange {plan.exchange!r} for kernel "
                         f"{plan.kernel!r}; expected one of {spec.shard_exchanges}")
    if plan.partition not in PARTITIONS:
        raise ValueError(f"unknown partition {plan.partition!r}; expected "
                         f"one of {PARTITIONS}")
    if plan.partition != "block" and "member" not in plan.layout:
        raise ValueError(f"partition={plan.partition!r} requires a "
                         f"vertex-sharded layout (a 'member' axis)")
    if plan.layout and plan.engine != "bitmap":
        raise ValueError(f"mesh layout {plan.layout} requires engine='bitmap' "
                         f"(got {plan.engine!r}); the legacy engines are "
                         f"single-device")
    if "root" in plan.layout and not plan.batch_roots:
        raise ValueError("layout with a 'root' axis requires batch_roots=True")
    if plan.batch_roots and plan.engine != "bitmap":
        raise ValueError(f"batch_roots=True requires engine='bitmap' (got "
                         f"{plan.engine!r}); use batch_roots=False for "
                         f"per-root runs")
    if plan.mesh_shape is not None:
        if not plan.layout:
            raise ValueError("mesh_shape given but layout is () (single "
                             "device has no mesh)")
        if len(plan.mesh_shape) != len(plan.layout):
            raise ValueError(f"mesh_shape {plan.mesh_shape} does not match "
                             f"layout {plan.layout} (need one size per axis)")
        if any(s < 1 for s in plan.mesh_shape):
            raise ValueError(f"mesh_shape sizes must be >= 1, got "
                             f"{plan.mesh_shape}")
        if "member" in plan.layout and not _is_pow2(
                plan.mesh_shape[plan.layout.index("member")]):
            raise ValueError(f"member axis size of {plan.mesh_shape} is not "
                             f"a power of two")
    if plan.n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {plan.n_chunks}")
    if plan.layout:
        raise _not_ported(f"layout={plan.layout!r}", "Multi-device layouts")


@dataclass
class PreparedGraph:
    """Graph-side inputs for :func:`compile_plan` (``pipeline.BuiltGraph``
    qualifies too)."""

    ev: Optional[EdgeView] = None
    degree: Optional[torch.Tensor] = None
    core: Optional[HeavyCore] = None
    chunks: Optional[ChunkedEdgeView] = None


@dataclass
class Graph500Result:
    """Uniform runner output."""

    parent: np.ndarray          # [R, V] int32
    level: np.ndarray           # [R, V] int32
    run: Graph500Run
    plan: TraversalPlan


# ---------------------------------------------------------------------------
# 2. compile_plan + the runner
# ---------------------------------------------------------------------------

def compile_plan(plan: TraversalPlan, built, *, device=None,
                 fault=None) -> "CompiledBFS":
    """Validate ``plan`` and prepare the graph for it on ``device``.

    ``device=None`` means the card, and raises without one; the graph's
    tensors must already lie on the resolved device.  The SSSP kernel
    needs the weight plane on ``built.ev`` (``with_edge_weights``); its
    bucket width comes from the largest weight.
    """
    validate_plan(plan)
    if fault is not None and plan.engine != "bitmap":
        raise ValueError(f"fault injection requires engine='bitmap' (got "
                         f"{plan.engine!r}); the legacy engines have no hooks")
    if fault is not None:
        raise _not_ported("fault injection", "Faults and checked execution")
    dev = resolve_device(device)
    pg = PreparedGraph(ev=getattr(built, "ev", None),
                       degree=getattr(built, "degree", None),
                       core=getattr(built, "core", None),
                       chunks=getattr(built, "chunks", None))
    if pg.ev is None:
        raise ValueError("plan needs built.ev (an EdgeView)")
    if pg.degree is None:
        raise ValueError("plan needs built.degree")
    needs_w = kernel_spec(plan.kernel).needs_weights
    if needs_w and pg.ev.weight is None:
        raise ValueError(f"kernel={plan.kernel!r} needs edge weights: attach "
                         f"them with with_edge_weights(ev) before compiling "
                         f"the plan")
    for name, t in (("ev.src", pg.ev.src), ("degree", pg.degree),
                    ("core.a_core", pg.core.a_core if pg.core else None)):
        if t is not None and t.device.type != dev.type:
            raise ValueError(f"built.{name} lies on {t.device}, the plan runs "
                             f"on {dev}: build the graph on the same device")
    if plan.engine == "bitmap" and (
            pg.chunks is None or pg.chunks.n_chunks != plan.n_chunks
            or (needs_w and pg.chunks.weight is None)):
        pg.chunks = chunk_edge_view(pg.ev, plan.n_chunks)
    # The dense core is a boolean-semiring step with no weight plane: only
    # the BFS kernel consults it.
    core = pg.core if plan.kernel == "bfs" else None
    delta = max_rounds = 0
    tail = None
    if plan.kernel == "sssp":
        delta = bucket_width(int(pg.ev.weight.max()))
        max_rounds = sssp_max_rounds(plan.max_levels)
    elif plan.engine == "bitmap":
        tail = bottom_up_tail(pg.chunks, core)
    return CompiledBFS(
        plan=plan, graph=pg, device=dev, num_vertices=pg.ev.num_vertices,
        n_active=int((pg.degree > 0).sum()), core=core, tail=tail,
        delta=delta, max_rounds=max_rounds)


@dataclass
class CompiledBFS:
    """A validated plan bound to one prepared graph on one device."""

    plan: TraversalPlan
    graph: PreparedGraph
    device: torch.device
    num_vertices: int
    n_active: int
    core: Optional[HeavyCore]   # the core the BFS engines consult, or None
    tail: Optional[tuple]       # bottom_up_tail of the bitmap BFS engine
    delta: int = 0              # SSSP bucket width
    max_rounds: int = 0         # SSSP round bound

    def _traverse(self, root: int) -> BFSResult:
        """One traversal of the plan's kernel and engine from ``root``."""
        g, p = self.graph, self.plan
        if p.kernel == "sssp":
            return _run_sssp_impl(g.chunks, g.degree, root, delta=self.delta,
                                  max_rounds=self.max_rounds)
        if p.engine == "bitmap":
            return _run_bitmap_impl(g.chunks, g.degree, self.n_active, root,
                                    self.core, alpha=p.alpha, beta=p.beta,
                                    max_levels=p.max_levels, tail=self.tail)
        return _run_legacy(g.ev, g.degree, self.n_active, root, self.core,
                           engine=p.engine, alpha=p.alpha, beta=p.beta,
                           max_levels=p.max_levels)

    def bfs(self, roots) -> BFSResult:
        """Raw traversal(s): a root vector under ``batch_roots`` (leaves
        come back ``[R, ...]``), else one scalar root."""
        if not self.plan.batch_roots:
            return self._traverse(int(roots))
        g, p = self.graph, self.plan
        roots = [int(r) for r in np.asarray(roots).reshape(-1)]
        if p.kernel == "sssp":
            return _run_sssp_batch(g.chunks, g.degree, roots, delta=self.delta,
                                   max_rounds=self.max_rounds)
        return _run_batch(g.chunks, g.degree, self.n_active, roots, self.core,
                          alpha=p.alpha, beta=p.beta, max_levels=p.max_levels,
                          tail=self.tail)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, roots, *, check: str = "post", retries: int = 0,
            fallback: bool = False) -> Graph500Result:
        """Graph500 steps 3 + 4 under this plan.

        Batched plans time the whole root batch and attribute
        wall-clock / n_roots to each search; per-root plans time each
        search.  The warm-up is one traversal of the first root by the
        plan's kernel and engine, outside the timed region (it builds and
        loads the kernels).

        ``check``: ``"off"`` (no checks, ``all_valid`` reports False),
        ``"post"`` (the kernel's five spec checks on every root, with
        per-check counts) or ``"full"`` (``"post"`` plus the in-loop
        sentinel trace as the ``"sentinel"`` check, for the engines that
        carry one).  ``retries``/``fallback`` (recovery of failing roots)
        are not ported yet and raise.  For SSSP the ``level`` rows hold
        the distances.
        """
        if check not in ("off", "post", "full"):
            raise ValueError(f"check must be 'off', 'post' or 'full' (got {check!r})")
        if retries or fallback:
            raise _not_ported("retries/fallback recovery",
                              "Faults and checked execution")
        roots_np = np.asarray(roots, np.int64).reshape(-1)
        n = len(roots_np)
        v = self.num_vertices
        g500 = Graph500Run(batched=self.plan.batch_roots)
        if n == 0:
            return Graph500Result(np.zeros((0, v), np.int32),
                                  np.zeros((0, v), np.int32), g500, self.plan)
        self._traverse(int(roots_np[0]))
        self._sync()

        if self.plan.batch_roots:
            t0 = time.perf_counter()
            res = self.bfs(roots_np)
            self._sync()
            times = [(time.perf_counter() - t0) / n] * n
        else:
            rows, times = [], []
            for r in roots_np:
                t0 = time.perf_counter()
                row = self.bfs(int(r))
                self._sync()
                times.append(time.perf_counter() - t0)
                rows.append(row)
            res = stack_results(rows)

        edges = traversed_edges(self.graph.degree, res.parent).cpu().numpy()
        g500.times_s = [float(dt) for dt in times]
        g500.edges = [int(m) for m in edges]
        g500.teps = [m / dt if dt > 0 else 0.0
                     for m, dt in zip(g500.edges, times)]

        counts, failures = _check_batch(
            self.graph.ev, res.parent, res.level, roots_np, check,
            res.stats.sentinel, kernel=self.plan.kernel)
        g500.check_counts = dict(counts)
        g500.check_failures = {int(roots_np[i]): list(names)
                               for i, names in failures.items()}
        if counts:
            g500.validated = [i not in failures for i in range(n)]
        return Graph500Result(res.parent.cpu().numpy(), res.level.cpu().numpy(),
                              g500, self.plan)


def _check_batch(ev, parents, levels, roots, check, sent, kernel="bfs"):
    """Per-check failure counts (zeros included whenever the spec checks
    ran) and a row-index -> failed-check-names map.  The checks are the
    kernel's; ``sent`` is the per-row in-loop sentinel trace, applied under
    ``check="full"`` (None for the engines without one)."""
    counts: dict[str, int] = {}
    failures: dict[int, list[str]] = {}
    if check != "off":
        counts, failures = failure_report(
            validate_result_batch(kernel, ev, parents, levels, roots))
    if check == "full" and sent is not None:
        sent = sent.cpu().numpy()
        bad = np.any((sent != -1) & (sent != SENTINEL_OK), axis=-1)
        counts["sentinel"] = int(np.sum(bad))
        for j in np.nonzero(bad)[0]:
            failures.setdefault(int(j), []).append("sentinel")
    return counts, failures
