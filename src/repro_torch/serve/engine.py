"""The persistent traversal serving engine (DESIGN.md §14).

Counterpart of ``repro.serve.engine`` on the port's plan layer.  ``Engine``
loads a graph once, resolves a :class:`~repro_torch.core.plan.BFSPlan`,
compiles it once on one device and then serves a stream of root queries
against the resident :class:`~repro_torch.core.plan.CompiledBFS`, through
the coalescer, the hot-root cache and the checked-batch requeue of
:mod:`repro_torch.serve.coalescer`.  It serves whichever Graph500 kernel its
plan names: BFS parent trees, or SSSP parents with the distances in the
``level`` rows.

Per batch the engine runs :meth:`CompiledBFS.serve_batch` (detect -> retry
-> degraded fallback) with padding rows masked out of every account; rows
that still fail go back to the coalescer, which re-queues their queries
rather than returning a wrong tree.  A batch's service time is the host
clock around that call, which returns once the rows are on the host, so it
is the device's real time for the batch.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.kernels import rekernel_plan
from repro_torch.core.plan import BFSPlan, compile_plan
from repro_torch.serve.cache import ParentCache
from repro_torch.serve.coalescer import BatchOutcome, CoalescePolicy, replay
from repro_torch.serve.metrics import ServeReport


@dataclass(frozen=True)
class ServeConfig:
    """Serving-side knobs, orthogonal to the traversal plan.

    ``batch_size``/``max_wait_s``/``max_requeues`` feed the
    :class:`CoalescePolicy`; ``cache_capacity`` sizes the hot-root LRU
    (0 disables); ``check`` is the per-batch verification mode;
    ``retries`` the in-batch re-solve budget before rows are handed back
    for re-queue; ``fallback_on_requeue`` arms the degraded single-
    device plan on batches that carry re-queued queries.
    """

    batch_size: int = 8
    max_wait_s: float = 2e-3
    cache_capacity: int = 128
    check: str = "post"
    retries: int = 0
    max_requeues: int = 2
    fallback_on_requeue: bool = True
    warmup: bool = True

    def policy(self) -> CoalescePolicy:
        return CoalescePolicy(batch_size=self.batch_size,
                              max_wait_s=self.max_wait_s,
                              max_requeues=self.max_requeues)


def resolve_serve_plan(scale: Optional[int] = None,
                       overrides: Optional[dict] = None,
                       *, batch_size: int = 8, device=None) -> BFSPlan:
    """The serving plan: the tuned-plan table's winner for ``scale`` on
    ``device``'s devices (None: the card) when available, the
    single-device batched bitmap plan otherwise; ``overrides`` always win
    (explicit > tuned > default).  ``batch_roots=True`` is forced (the
    coalescer's whole job is building root batches)."""
    plan = None
    if scale is not None:
        from repro_torch.core.tune import device_view, tuned_plan
        n_devices, backend = device_view(device)
        plan = tuned_plan(scale, n_devices, backend, overrides=overrides)
    if plan is None:
        plan = BFSPlan(engine="bitmap", layout=(), batch_roots=True)
        if overrides:
            plan = dataclasses.replace(plan, **overrides)
    if not plan.batch_roots:
        plan = dataclasses.replace(plan, batch_roots=True)
    return plan


class Engine:
    """Compile once, serve forever.

    ``built`` is a :class:`~repro_torch.core.pipeline.BuiltGraph` (or any
    ``PreparedGraph``-compatible object) on ``device`` (None: the card);
    ``plan`` an explicit :class:`BFSPlan`, else resolved by
    :func:`resolve_serve_plan` from ``scale``/``plan_overrides`` (the tuned
    plan of ``scale`` on ``device``'s devices); ``kernel``
    retargets the plan through ``rekernel_plan``.  ``mesh`` (a
    :class:`~repro_torch.comms.mesh.Mesh`, e.g. a virtual one) is the mesh a
    layout plan compiles on, as ``compile_plan(mesh=)`` takes it.  ``fault``
    threads a :class:`~repro_torch.core.faults.FaultSpec` into every
    traversal, to exercise the checked-serving path.
    """

    def __init__(self, built, plan: Optional[BFSPlan] = None, *,
                 config: Optional[ServeConfig] = None,
                 scale: Optional[int] = None,
                 plan_overrides: Optional[dict] = None,
                 mesh=None, fault=None, kernel: Optional[str] = None,
                 device=None):
        self.config = config or ServeConfig()
        if plan is None:
            plan = resolve_serve_plan(scale, plan_overrides,
                                      batch_size=self.config.batch_size,
                                      device=device)
        elif not plan.batch_roots:
            plan = dataclasses.replace(plan, batch_roots=True)
        if kernel is not None:
            plan = rekernel_plan(plan, kernel)
        self.plan = plan
        self.compiled = compile_plan(plan, built, device=device, mesh=mesh,
                                     fault=fault)
        self.cache = ParentCache(self.config.cache_capacity)
        self.batches_served = 0
        if self.config.warmup:
            # build and load the kernels now, not on query 1
            roots = np.zeros(self.config.batch_size, np.int32)
            self.compiled.serve_batch(roots, check=self.config.check)

    def reset_cache(self) -> None:
        """Fresh hot-root cache (counters included).  The cache persists
        across :meth:`serve` calls by default (a long-lived server keeps
        its heat), so independent measurements must reset explicitly."""
        self.cache = ParentCache(self.config.cache_capacity)

    def solve_batch(self, padded_roots: np.ndarray, n_real: int,
                    use_fallback: bool) -> BatchOutcome:
        """One measured, checked batch traversal: the coalescer's
        ``solve_fn``.  Padding rows (>= ``n_real``) are masked from the
        failure set and from the per-check counts."""
        cfg = self.config
        t0 = time.perf_counter()
        sb = self.compiled.serve_batch(
            padded_roots, check=cfg.check, retries=cfg.retries,
            fallback=use_fallback and cfg.fallback_on_requeue)
        service_s = time.perf_counter() - t0   # the rows are on the host
        real_failures = {i: names for i, names in sb.failures.items()
                         if i < n_real}
        counts = {name: 0 for name in sb.counts}
        for names in real_failures.values():
            for name in names:
                counts[name] = counts.get(name, 0) + 1
        self.batches_served += 1
        return BatchOutcome(sb.parent, sb.level,
                            failed_rows=set(real_failures),
                            service_s=service_s, check_counts=counts)

    def serve(self, trace) -> ServeReport:
        """Replay a query stream (a :class:`~repro_torch.data.query_trace.
        QueryTrace` or an iterable of coalescer ``Query``) through the
        resident compiled plan and return the full report."""
        queries = trace.queries() if hasattr(trace, "queries") else list(trace)
        answers, batches = replay(queries, self.config.policy(),
                                  self.solve_batch, cache=self.cache)
        return ServeReport(
            answers=answers, batches=batches,
            cache_stats=self.cache.stats(),
            meta={
                "plan": self.plan.to_dict(),
                "batch_size": self.config.batch_size,
                "max_wait_s": self.config.max_wait_s,
                "check": self.config.check,
                "n_vertices": self.compiled.num_vertices,
            })
