"""Graph500 TEPS accounting (spec §Output).

``m`` counts undirected input edges inside the traversed component: half
the visited-degree sum over the deduped symmetric structure, summed in
int64.  The headline figure is the harmonic mean TEPS over the search keys.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.bfs_steps import DEFAULT_CHUNKS, EdgeView


def traversed_edges(degree: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """Half the degree sum over visited vertices; ``parent`` is [V] or [R, V]."""
    return torch.where(parent >= 0, degree.to(torch.int64), 0).sum(dim=-1) // 2


def batch_harmonic_mean_teps(degree, parents, per_root_s: float) -> float:
    """Harmonic-mean TEPS of a ``[R, V]`` parent batch at a uniform per-root
    wall time."""
    t = traversed_edges(degree, parents).cpu().numpy() / per_root_s
    t = t[t > 0]
    return float(len(t) / np.sum(1.0 / t)) if len(t) else 0.0


@dataclass
class Graph500Run:
    teps: list[float] = field(default_factory=list)
    times_s: list[float] = field(default_factory=list)
    edges: list[int] = field(default_factory=list)
    validated: list[bool] = field(default_factory=list)
    batched: bool = False
    # Checked-execution bookkeeping: ``check_counts`` maps check name ->
    # number of roots failing it (zeros included when checks ran; empty
    # when check="off"); ``check_failures`` maps failing root id -> failed
    # check names.  ``retries`` / ``fallbacks`` count roots re-solved per
    # recovery stage; ``quarantined`` lists root ids still failing
    # afterwards (their TEPS is forced to 0.0, excluding them from the
    # hmean).
    retries: int = 0
    fallbacks: int = 0
    quarantined: list[int] = field(default_factory=list)
    check_counts: dict[str, int] = field(default_factory=dict)
    check_failures: dict[int, list[str]] = field(default_factory=dict)

    @property
    def harmonic_mean_teps(self) -> float:
        t = np.asarray(self.teps)
        t = t[t > 0]
        return float(len(t) / np.sum(1.0 / t)) if len(t) else 0.0

    @property
    def mean_time_s(self) -> float:
        return float(np.mean(self.times_s)) if self.times_s else 0.0

    @property
    def all_valid(self) -> bool:
        return all(self.validated) if self.validated else False


def run_graph500(
    ev: EdgeView,
    degree: torch.Tensor,
    roots,
    *,
    core=None,
    engine: str = "reference",
    alpha: float = 14.0,
    beta: float = 24.0,
    do_validate: bool = True,
    warmup: bool = True,
    n_chunks: int = DEFAULT_CHUNKS,
    device=None,
) -> Graph500Run:
    """Timed BFS over the given roots (Graph500 step 3 + 4), one at a time.

    A per-root plan run: ``BFSPlan(engine=engine, layout=(),
    batch_roots=False)`` - the chunked edge view is built once at compile
    time (graph construction is untimed per spec) and each search is timed
    separately, closest to the Graph500 reference code's timing loop.  With
    ``do_validate=False`` every root is marked validated.  ``device``: as
    :func:`~repro_torch.core.plan.compile_plan` (the graph's tensors must
    lie on it).
    """
    from repro_torch.core.plan import BFSPlan, PreparedGraph, compile_plan

    p = BFSPlan(engine=engine, layout=(), batch_roots=False,
                alpha=alpha, beta=beta, n_chunks=n_chunks)
    compiled = compile_plan(p, PreparedGraph(ev=ev, degree=degree, core=core),
                            device=device)
    run = compiled.run(roots, warmup=warmup, do_validate=do_validate).run
    if not do_validate:
        run.validated = [True] * len(run.teps)
    return run
