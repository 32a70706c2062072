"""Seeded synthetic query traces for the BFS serving subsystem
(DESIGN.md §14).  A copy of ``repro.data.query_trace``: the same seed gives
the same trace bit for bit in both packages.

Production BFS traffic has two robust statistical signatures the server
must be tuned against: arrivals are bursty (well modeled as a Poisson
process — exponential inter-arrival gaps) and root popularity is heavy-
tailed (a few hot entities dominate queries).  We model popularity as a
Zipf law over the **degree-sorted vertex ids**: after `sort_by_degree`
relabeling, low ids are the high-degree hubs, which is exactly the
population real queries concentrate on — so the same trace that drives
the latency bench also exercises the hot-root cache realistically.

Everything is `numpy.random.default_rng(seed)`-driven: same seed, same
trace, bit for bit — cache hit rates and tail latencies in BENCH and CI
are reproducible numbers, not weather.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class QueryTrace:
    """A deterministic query stream: ``roots[i]`` arrives at
    ``arrival_s[i]`` (non-decreasing)."""

    arrival_s: np.ndarray       # [N] float64, sorted
    roots: np.ndarray           # [N] int32 vertex ids
    seed: int
    rate_qps: float
    zipf_s: float
    n_vertices: int

    def __len__(self) -> int:
        return len(self.roots)

    def queries(self):
        """Materialize as coalescer :class:`~repro_torch.serve.coalescer.Query`
        objects (imported lazily so `data` stays serve-independent)."""
        from repro_torch.serve.coalescer import Query
        return [Query(qid=i, root=int(r), arrival_s=float(t))
                for i, (t, r) in enumerate(zip(self.arrival_s, self.roots))]


def synth_trace(seed: int, n_queries: int, n_vertices: int, *,
                rate_qps: float = 500.0, zipf_s: float = 1.1,
                degree=None, start_s: float = 0.0) -> QueryTrace:
    """Poisson arrivals x Zipf root popularity.

    ``zipf_s`` is the popularity exponent (rank ``k`` drawn with weight
    ``(k+1)^-s``; larger = hotter head = higher cache hit rate).  When
    ``degree`` (per-vertex degree array or tensor, on any device) is given,
    roots are drawn only
    from vertices with at least one edge — matching the Graph500 rule
    that sampled search keys have nonzero degree — ranked in id order,
    which after degree-sort relabeling IS popularity-by-degree.
    """
    if n_queries < 1:
        raise ValueError(f"n_queries must be >= 1, got {n_queries}")
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    rng = np.random.default_rng(seed)
    if degree is not None:
        deg = degree.cpu().numpy() if hasattr(degree, "cpu") else np.asarray(degree)
        ids = np.flatnonzero(deg > 0).astype(np.int32)
        if ids.size == 0:
            raise ValueError("degree mask leaves no candidate roots")
    else:
        ids = np.arange(n_vertices, dtype=np.int32)
    w = (np.arange(ids.size, dtype=np.float64) + 1.0) ** -float(zipf_s)
    roots = rng.choice(ids, size=n_queries, p=w / w.sum())
    gaps = rng.exponential(1.0 / rate_qps, size=n_queries)
    arrival = start_s + np.cumsum(gaps)
    return QueryTrace(arrival_s=arrival, roots=roots.astype(np.int32),
                      seed=int(seed), rate_qps=float(rate_qps),
                      zipf_s=float(zipf_s), n_vertices=int(n_vertices))
