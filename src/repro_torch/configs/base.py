"""Architecture registry and shape cells: the port's copy of the parts of
``repro.configs.base`` that its architectures use.

An ``ArchSpec`` names an architecture's full config (published dims) and a
reduced smoke config; its shape cells are the family's batch shapes.  The
registry holds what the JAX package's does: the five LM archs, the four GNN
archs, ``xdeepfm`` and ``graph500``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

REGISTRY: dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                 # train | prefill | decode | full_graph |
    #                           minibatch | batched_small | serve |
    #                           retrieval | bfs
    dims: dict[str, Any]
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str               # lm | gnn | recsys | graph500
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: tuple[ShapeCell, ...]
    source: str = ""
    notes: str = ""

    def shape(self, name: str) -> ShapeCell:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r}")


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.arch_id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    return REGISTRY[arch_id]


def all_arch_ids() -> list[str]:
    _ensure_loaded()
    return sorted(REGISTRY)


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) cell of the registered architectures."""
    _ensure_loaded()
    return [(a, s.name) for a in all_arch_ids() for s in REGISTRY[a].shapes]


def _ensure_loaded():
    from repro_torch import configs as _c  # noqa: F401  (imports register all)


LM_SHAPES = (
    ShapeCell("train_4k", "train", dict(seq_len=4096, global_batch=256)),
    ShapeCell("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeCell("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
    ShapeCell("long_500k", "decode", dict(seq_len=524288, global_batch=1),
              note="SKIP(full-attn) for pure full-attention archs; "
                   "supplementary sliding-window row lowered instead"),
)

GNN_SHAPES = (
    ShapeCell("full_graph_sm", "full_graph",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
    ShapeCell("minibatch_lg", "minibatch",
              dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                   fanout=(15, 10), d_feat=602)),
    ShapeCell("ogb_products", "full_graph",
              dict(n_nodes=2449029, n_edges=61859140, d_feat=100)),
    ShapeCell("molecule", "batched_small",
              dict(n_nodes=30, n_edges=64, batch=128)),
)

RECSYS_SHAPES = (
    ShapeCell("train_batch", "train", dict(batch=65536)),
    ShapeCell("serve_p99", "serve", dict(batch=512)),
    ShapeCell("serve_bulk", "serve", dict(batch=262144)),
    ShapeCell("retrieval_cand", "retrieval",
              dict(batch=1, n_candidates=1_000_000)),
)

GRAPH500_SHAPES = (
    ShapeCell("bfs_s22", "bfs", dict(scale=22, edge_factor=16)),
    ShapeCell("bfs_s26", "bfs", dict(scale=26, edge_factor=16)),
)
