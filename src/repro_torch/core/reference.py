"""Sequential host BFS — the "reference-3.0.0 just make then run" rung of
the paper's Fig. 18 ladder, and an independent oracle for tests.

A copy of ``repro.core.reference`` (numpy only), so that the port
imports nothing of the JAX package.

Deliberately unoptimized queue BFS over a numpy CSR (matches the spirit of
the Graph500 reference code's simple sequential validation path).
"""
from __future__ import annotations

from collections import deque

import numpy as np


def reference_bfs(row_offsets: np.ndarray, col_indices: np.ndarray, root: int):
    """Returns (parent, level) int64 arrays; -1 = unvisited; parent[root]=root."""
    v = len(row_offsets) - 1
    parent = np.full(v, -1, np.int64)
    level = np.full(v, -1, np.int64)
    parent[root] = root
    level[root] = 0
    q = deque([root])
    while q:
        u = q.popleft()
        for e in range(row_offsets[u], row_offsets[u + 1]):
            w = col_indices[e]
            if w >= v:
                continue  # padding sentinel
            if parent[w] < 0:
                parent[w] = u
                level[w] = level[u] + 1
                q.append(w)
    return parent, level


def reference_levels(row_offsets, col_indices, root):
    return reference_bfs(row_offsets, col_indices, root)[1]
