"""Serving-run report: latency percentiles, throughput, occupancy
(DESIGN.md §14).  A copy of ``repro.serve.metrics``.

Latency-metric definitions (all from the replay's virtual clock):

  * **query latency** — ``done_s - arrival_s`` of the ORIGINAL arrival;
    re-queued queries accumulate every failed flight, cache hits are
    near-zero, padding rows never appear (they are not queries);
  * **pNN** — ``numpy.percentile(latencies, NN)`` over every resolved
    query including ``failed`` ones (a refused answer still made the
    caller wait; excluding it would let faults *improve* the tail);
  * **qps** — resolved queries / (last done - first arrival), the
    sustained rate over the whole replay, not a burst number;
  * **occupancy** — real unique roots / batch capacity per launch;
    the histogram exposes the deadline/size trade-off directly.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ServeReport:
    """Everything one replay produced: per-query answers, per-batch
    records, cache counters, and plan/config metadata for BENCH."""

    answers: list
    batches: list
    cache_stats: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    def summary(self) -> dict:
        """JSON-ready aggregate (the BENCH payload body)."""
        lat = np.asarray([a.latency_s for a in self.answers], np.float64)
        kinds: dict[str, int] = {}
        for a in self.answers:
            kinds[a.kind] = kinds.get(a.kind, 0) + 1
        out: dict = {
            "n_queries": len(self.answers),
            "kinds": dict(sorted(kinds.items())),
            "n_batches": len(self.batches),
            "cache": dict(self.cache_stats),
        }
        if lat.size:
            done = max(a.done_s for a in self.answers)
            first = min(a.arrival_s for a in self.answers)
            span = done - first
            out.update({
                "latency_p50_s": float(np.percentile(lat, 50)),
                "latency_p99_s": float(np.percentile(lat, 99)),
                "latency_p999_s": float(np.percentile(lat, 99.9)),
                "latency_mean_s": float(lat.mean()),
                "latency_max_s": float(lat.max()),
                "qps": float(len(self.answers) / span) if span > 0
                       else float("inf"),
            })
        if self.batches:
            occ = np.asarray([b.n_roots for b in self.batches], np.int64)
            cap = self.batches[0].n_roots + self.batches[0].n_pad
            hist = np.bincount(occ, minlength=cap + 1)
            pad = sum(b.n_pad for b in self.batches)
            slots = sum(b.n_roots + b.n_pad for b in self.batches)
            counts: dict[str, int] = {}
            for b in self.batches:
                for name, c in b.check_counts.items():
                    counts[name] = counts.get(name, 0) + int(c)
            out.update({
                "occupancy_mean": float(occ.mean()) / cap,
                # index i = number of launches that carried i real roots
                "occupancy_hist": [int(c) for c in hist],
                "padding_fraction": pad / slots if slots else 0.0,
                "fallback_batches": sum(1 for b in self.batches
                                        if b.used_fallback),
                "check_counts": dict(sorted(counts.items())),
            })
        if self.meta:
            out["meta"] = dict(self.meta)
        return out
