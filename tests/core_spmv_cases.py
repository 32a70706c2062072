"""Inputs for ``core_spmv``'s early exit, shared by the CPU and the card
tests: a packed core whose rows have their first frontier hit at chosen
words, and the words a read of each row up to the group of that hit takes,
walked group by group.

The kernel reads a row in groups of ``ref.CORE_GROUP_WORDS`` words and stops
after the first group with a hit, so the positions that matter are the
group's edges: word 0, the last word of a group and the first of the next,
the first word of the row's last, short group (when the row's length is no
multiple of a group) and the last word of the row; and rows with no hit.

:func:`core_step_runs` says, from a search's result alone, which of its
bottom-up levels launch the core step at all.
"""
import numpy as np

from repro_torch.core.hybrid_bfs import BOTTOM_UP
from repro_torch.kernels import ref

NO_HIT = -1


def rand_u32(rng, shape, density=0.5):
    bits = rng.random(shape + (32,)) < density
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little") \
        .view(np.uint32).reshape(shape)


def edge_positions(w: int) -> list:
    """The words of a ``w``-word row at a group's edges, and ``NO_HIT``."""
    g = ref.CORE_GROUP_WORDS
    pos = [0, g - 1, g, 2 * g - 1, 2 * g, w - 1, NO_HIT]
    if w % g:
        pos.append(w - w % g)
    return sorted({p for p in pos if p < w})


def first_hit_core(rng, k: int, w: int, density: float = 0.3):
    """(core uint32 [k, w], frontier uint32 [w], first-hit word of each row):
    the rows cycle through :func:`edge_positions`, then random words and
    ``NO_HIT``; every word of the frontier holds a bit, and a row's words
    past its first hit hit at random."""
    f = rand_u32(rng, (w,), density)
    f[f == 0] = 1
    edges = edge_positions(w)
    pos = np.array((edges * (k // len(edges) + 1))[:k], np.int64)
    spread = rng.random(k) < 0.5
    pos[spread] = rng.integers(NO_HIT, w, size=int(spread.sum()))
    a = rand_u32(rng, (k, w), density) & ~f
    hit = rand_u32(rng, (k, w), density) & f
    later = (np.arange(w)[None, :] > pos[:, None]) & (pos[:, None] != NO_HIT)
    a = np.where(later, a | hit, a)
    rows = np.nonzero(pos != NO_HIT)[0]
    fp = f[pos[rows]]
    a[rows, pos[rows]] |= (fp & (~fp + np.uint32(1))) | hit[rows, pos[rows]]
    return a, f, pos


def walked_words(a: np.ndarray, f: np.ndarray) -> int:
    """The words a read of every row takes, group by group, up to the end of
    the first group with a hit (all of the row when none has one)."""
    g = ref.CORE_GROUP_WORDS
    w = a.shape[1]
    hits = (a & f[None, :]) != 0
    total = 0
    for row in hits:
        read = w
        for g0 in range(0, w, g):
            if row[g0:g0 + g].any():
                read = min(g0 + g, w)
                break
        total += read
    return total


def core_step_runs(res, core_rows: int) -> list:
    """Whether each level of one search's result launches the core step
    (``core_spmv`` and the merge): a bottom-up level L does when a row
    i < ``core_rows`` (min(K, V)) is unvisited as L begins, its level -1 or
    above L; the other bottom-up levels skip the step."""
    levels = res.level[:core_rows].cpu()
    return [int(res.stats.direction[lvl]) == BOTTOM_UP
            and bool(((levels == -1) | (levels > lvl)).any())
            for lvl in range(int(res.stats.levels))]


def core_steps(res, core_rows: int) -> tuple[int, int]:
    """(bottom-up levels, those that launch the core step) of one search's
    result (:func:`core_step_runs`)."""
    n = int(res.stats.levels)
    n_bu = int((res.stats.direction[:n] == BOTTOM_UP).sum())
    return n_bu, sum(core_step_runs(res, core_rows))
