"""Graph500 TEPS arithmetic (specification, "Output"), kept in the benchmark.

A search's traversed edges are the undirected input edges inside the
component it reached: half the degree sum of the reached vertices, over
the graph with self loops dropped and duplicates merged.  Its TEPS is that
count over its own time; a run reports the harmonic mean over its
searches.
"""
from __future__ import annotations

import torch


def traversed_edges(degree: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """int64 scalar tensor: half the degree sum where ``parent >= 0``."""
    return torch.where(parent >= 0, degree.to(torch.int64), 0).sum() // 2


def harmonic_mean_teps(edges, seconds) -> float:
    """Harmonic mean of ``edges[i] / seconds[i]`` over the searches that
    traversed an edge."""
    inv = [t / m for m, t in zip(edges, seconds) if m > 0 and t > 0]
    return len(inv) / sum(inv) if inv else 0.0
