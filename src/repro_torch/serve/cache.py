"""Hot-root parent cache for the BFS serving engine (DESIGN.md §14).
A copy of ``repro.serve.cache``.

A fixed-capacity LRU keyed by root vertex id.  Coherence is structural,
not temporal: the engine owns ONE immutable compiled graph for its whole
lifetime and every traversal of the same root through the same
:class:`~repro_torch.core.plan.CompiledBFS` is deterministic (the scatter-min
parent convention has no data races to order), so a cached answer is
*bitwise-identical* to a fresh traversal by construction — there is no
invalidation protocol because there is nothing that can go stale.  The
rows are stored read-only so a downstream consumer cannot corrupt the
shared copy.

Zipf-shaped production traffic (hot roots repeat) makes this the
cheapest capacity multiplier the server has: a hit costs one ordered-
dict move instead of a mesh-wide traversal.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np


class CachedAnswer(NamedTuple):
    """One root's traversal result (read-only views)."""

    parent: np.ndarray          # [V] int32
    level: np.ndarray           # [V] int32


def _frozen(row: np.ndarray) -> np.ndarray:
    out = np.array(row, copy=True)
    out.flags.writeable = False
    return out


class ParentCache:
    """LRU of ``root -> (parent, level)`` rows with hit/miss/eviction
    counters.  ``capacity=0`` disables caching (every get is a miss,
    puts are dropped) so the serving path needs no branches."""

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError(f"cache capacity must be >= 0, got {capacity}")
        self.capacity = int(capacity)
        self._rows: OrderedDict[int, CachedAnswer] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, root) -> bool:
        """Membership probe — does NOT touch recency or the counters."""
        return int(root) in self._rows

    def roots(self) -> list:
        """Resident roots, least- to most-recently used."""
        return list(self._rows)

    def get(self, root) -> Optional[CachedAnswer]:
        """Lookup + recency bump; counts one hit or one miss."""
        root = int(root)
        ans = self._rows.get(root)
        if ans is None:
            self.misses += 1
            return None
        self._rows.move_to_end(root)
        self.hits += 1
        return ans

    def put(self, root, parent: np.ndarray, level: np.ndarray) -> None:
        """Insert/refresh a root's answer, evicting the LRU entry past
        capacity.  Overwriting an existing root is a refresh (recency
        bump), never an eviction."""
        if self.capacity == 0:
            return
        root = int(root)
        self._rows[root] = CachedAnswer(_frozen(parent), _frozen(level))
        self._rows.move_to_end(root)
        while len(self._rows) > self.capacity:
            self._rows.popitem(last=False)
            self.evictions += 1

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self) -> dict:
        """JSON-ready counter snapshot (BENCH / report metadata)."""
        return {
            "capacity": self.capacity,
            "size": len(self._rows),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }
