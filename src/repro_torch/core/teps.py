"""Graph500 TEPS accounting (spec §Output).

``m`` counts undirected input edges inside the traversed component: half
the visited-degree sum over the deduped symmetric structure, summed in
int64.  The headline figure is the harmonic mean TEPS over the search keys.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


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
