"""Peaks of the card and the bytes and operations of the hand-written kernels.

Peaks: one NVIDIA H100 SXM5 (80 GB HBM3) at its full 700 W, from NVIDIA's
data sheet; the run prints the card's power limit beside every share,
since a card set below 700 W reaches less.

A kernel's bound is the larger of its bytes over the memory bandwidth and
its operations over the peak rate; its roofline share is the bound over
the measured device time.  Bytes count each input byte the inputs need
read once and each output byte written once.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12          # HBM3, SXM5
SCALAR_OPS_PER_S = 67e12           # fp32 / int32 outside the tensor cores

BIG = 1 << 30                      # core_spmv's "no frontier neighbour"


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / SCALAR_OPS_PER_S)


def sssp_relax_bound_s(frontier_entries: int, rounds: int, vertices: int) -> float:
    """The ``sssp_relax`` call of each of ``rounds`` rounds over ``vertices``
    vertices, whose frontiers' rows hold ``frontier_entries`` entries in all:
    the frontier's scan reads each vertex's frontier degree (int32, 4 B), and
    the relax each frontier entry's destination and weight (int32 each,
    8 B), an add and a compare.  Left out, so the count stays a lower bound:
    the scan's second read of the degrees, the frontier list it writes and
    the relax reads back, the rows' offsets, and the packed state's reads
    and atomics, which the L2 holds at scale 22 (8 B a vertex)."""
    return bound_s(4 * vertices * rounds + 8 * frontier_entries, 2 * frontier_entries)


def frontier_update_bound_s(words: int) -> float:
    """``frontier_update`` over int32 bitmaps of ``words`` words: reads the
    raw delta and the visited map, writes the next frontier and the new
    visited map and the count; about five operations a word."""
    return bound_s(16 * words + 4, 5 * words)


def _core_spmv_counts(out: torch.Tensor, words: int) -> tuple[int, int]:
    k = int(out.numel())
    o = out.to(torch.int64)
    need = torch.where(o < BIG, o // 32 + 1, words).clamp(max=words)
    row_words = int(need.sum())
    return 4 * (row_words + int(need.max()) + k), 5 * row_words


def core_spmv_bytes(outs: list, words: int) -> float:
    """Mean bytes a call that the inputs of the calls with outputs ``outs`` need."""
    return sum(_core_spmv_counts(o, words)[0] for o in outs) / len(outs)


def core_spmv_bound_s(out: torch.Tensor, words: int) -> float:
    """``core_spmv`` over a ``[K, words]`` packed core, from the launch's
    output ``out`` (int32 [K]: the least frontier neighbour of each row, BIG
    when none).  A row needs its words up to and including the first with a
    hit, or all of them when none hits; the frontier is read up to the
    longest such prefix; the output is written once.  Five operations a
    word read."""
    return bound_s(*_core_spmv_counts(out, words))
