"""Architecture registry and shape cells: the port's copy of the parts of
``repro.configs.base`` that its architectures use.

An ``ArchSpec`` names an architecture's full config (published dims) and a
reduced smoke config; its shape cells are the family's batch shapes.  The
registry holds what the port runs: ``xdeepfm`` and ``graph500``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

REGISTRY: dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                 # train | serve | retrieval | bfs
    dims: dict[str, Any]
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str               # recsys | graph500
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
