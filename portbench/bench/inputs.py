"""The inputs of a configuration: its edge list and its search keys.

The edge list is the Graph500 specification's Kronecker generator (R-MAT
initiator A, B, C, D; ``edge_factor << scale`` tuples; vertex labels and
tuple order randomly permuted), drawn bit position by bit position on a
``torch.Generator`` of the device.  The keys are the specification's
sampler: distinct vertices, drawn at random, with at least one edge that is
no self loop.  Both are frozen copies kept in the benchmark, so a change to
the program's generator or sampler cannot change the graph a cell measures.

A run draws two graphs.  The timed graph and its keys come from the
configuration's ``graph_seed``, so every run of a cell does the same work.
The checked graph and its keys come from the run's ``--seed``
(:func:`checked_graph_seed`); the run checks the program on it after the
window, so every seed checks a graph of its own.
"""
from __future__ import annotations

import torch

KEY_STREAM = 0x6B657973     # the key sampler's stream, apart from the edges'
GRAPH_STREAM = 0x67726170   # the checked graph's seed, apart from the run's


def kronecker_edges(seed: int, scale: int, edge_factor: int, a: float, b: float,
                    c: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 ``(src, dst)`` of ``edge_factor * 2**scale`` tuples."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = 1 << scale
    m = edge_factor << scale
    ab = a + b
    c_norm, a_norm = c / (1.0 - ab), a / ab
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        thresh = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(m, generator=gen, device=device) > thresh
        src |= ii.to(torch.int32) << bit
        dst |= jj.to(torch.int32) << bit
    label = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    order = torch.randperm(m, generator=gen, device=device)
    return label[src.long()][order], label[dst.long()][order]


def graph(doc: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The edge list of configuration ``doc`` drawn from ``seed``."""
    return kronecker_edges(seed, doc["scale"], doc["edge_factor"], doc["A"], doc["B"],
                           doc["C"], device)


def search_keys(seed: int, src: torch.Tensor, dst: torch.Tensor, n: int,
                n_keys: int) -> torch.Tensor:
    """int64 [n_keys] distinct input-label vertex ids, each with an edge
    that is no self loop."""
    loops = src == dst
    degree = (torch.bincount(src[~loops].long(), minlength=n)
              + torch.bincount(dst[~loops].long(), minlength=n))
    cand = torch.nonzero(degree > 0).squeeze(1)
    if cand.numel() < n_keys:
        raise ValueError(f"{cand.numel()} candidate keys, {n_keys} needed")
    gen = torch.Generator(device=src.device).manual_seed(int(seed) ^ KEY_STREAM)
    pick = torch.randperm(cand.numel(), generator=gen, device=src.device)[:n_keys]
    return cand[pick]


def checked_graph_seed(run_seed: int) -> int:
    """The seed of the graph a run checks after its window."""
    return (int(run_seed) ^ GRAPH_STREAM) & (2**63 - 1)
