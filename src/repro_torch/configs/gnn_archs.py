"""The four GNN architectures: the port's copy of ``repro.configs.gnn_archs``.

Feature dims adapt to the shape cell (every GNN arch pairs with every GNN
shape; d_feat/d_in comes from the cell, bound by :func:`arch_with_dims`).
The geometric models (DimeNet, EquiformerV2) receive synthetic edge vectors
on non-molecular graphs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchSpec, GNN_SHAPES, register
from repro_torch.models.gnn import (
    DimeNetConfig,
    EquiformerConfig,
    GATConfig,
    SAGEConfig,
)

# gat-cora [arXiv:1710.10903; paper]
register(ArchSpec(
    arch_id="gat-cora", family="gnn",
    make_config=lambda: GATConfig(n_layers=2, d_hidden=8, n_heads=8),
    make_smoke_config=lambda: GATConfig(n_layers=2, d_hidden=4, n_heads=2,
                                        d_in=16, n_classes=4),
    shapes=GNN_SHAPES, source="arXiv:1710.10903; paper"))

# graphsage-reddit [arXiv:1706.02216; paper]
register(ArchSpec(
    arch_id="graphsage-reddit", family="gnn",
    make_config=lambda: SAGEConfig(n_layers=2, d_hidden=128,
                                   sample_sizes=(25, 10)),
    make_smoke_config=lambda: SAGEConfig(n_layers=2, d_hidden=16, d_in=16,
                                         n_classes=4, sample_sizes=(3, 2)),
    shapes=GNN_SHAPES, source="arXiv:1706.02216; paper"))

# dimenet [arXiv:2003.03123; unverified]
register(ArchSpec(
    arch_id="dimenet", family="gnn",
    make_config=lambda: DimeNetConfig(n_blocks=6, d_hidden=128, n_bilinear=8,
                                      n_spherical=7, n_radial=6),
    make_smoke_config=lambda: DimeNetConfig(n_blocks=2, d_hidden=16,
                                            n_bilinear=2, n_spherical=3,
                                            n_radial=3),
    shapes=GNN_SHAPES, source="arXiv:2003.03123; unverified",
    notes="triplet lists static-capped at 8 x n_edges on non-molecular cells"))

# equiformer-v2 [arXiv:2306.12059; unverified]
register(ArchSpec(
    arch_id="equiformer-v2", family="gnn",
    make_config=lambda: EquiformerConfig(n_layers=12, d_hidden=128, l_max=6,
                                         m_max=2, n_heads=8),
    make_smoke_config=lambda: EquiformerConfig(n_layers=2, d_hidden=8,
                                               l_max=2, m_max=1, n_heads=2),
    shapes=GNN_SHAPES, source="arXiv:2306.12059; unverified",
    notes="eSCN SO(2) per-m block convolutions; Wigner rotation simplified "
          "(DESIGN.md §6)"))


def arch_with_dims(cfg, d_in: int, n_classes: int = 16):
    """Bind a shape cell's feature dims into the arch config."""
    if isinstance(cfg, (GATConfig, SAGEConfig)):
        return dataclasses.replace(cfg, d_in=d_in, n_classes=n_classes)
    return cfg
