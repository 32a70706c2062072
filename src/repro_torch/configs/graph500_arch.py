"""The paper's own workload as an architecture: hybrid BFS on the port's
``Graph500Config`` (the counterpart of ``repro.configs.graph500_arch``)."""
from __future__ import annotations

from repro_torch.configs.base import GRAPH500_SHAPES, ArchSpec, register
from repro_torch.core.pipeline import Graph500Config

register(ArchSpec(
    arch_id="graph500", family="graph500",
    make_config=lambda: Graph500Config(scale=26, n_roots=64,
                                       engine="bitmap", heavy_threshold=100),
    make_smoke_config=lambda: Graph500Config(scale=10, n_roots=4,
                                             engine="bitmap",
                                             heavy_threshold=8),
    shapes=GRAPH500_SHAPES, source="paper (Gan 2021)",
    notes="hybrid BFS; the vertex-sharded layouts exchange the frontier "
          "with the T3 monitor collectives"))
