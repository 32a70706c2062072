"""Graph500 Kronecker edge-list generator (spec v3, R-MAT parameters).

Counterpart of ``repro.core.kronecker`` on a ``torch.Generator``::

    ab = A + B; c_norm = C / (1 - ab); a_norm = A / ab
    for ib in 1..scale:
        ii_bit = rand(M) > ab
        jj_bit = rand(M) > (c_norm * ii_bit + a_norm * ~ii_bit)
        ij   += 2^(ib-1) * [ii_bit; jj_bit]

with A, B, C, D = 0.57, 0.19, 0.19, 0.05 and edge factor 16.  The random
bits are drawn one bit position at a time, so memory stays O(M) rather than
O(scale * M).  torch's generator cannot replay ``jax.random``'s threefry
stream: the same seed gives another graph of the same distribution.  Nor do
torch's CPU and CUDA generators share a stream, so the graph and the roots
of a seed depend on the device they are drawn on.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.util import resolve_device

A, B, C, D = 0.57, 0.19, 0.19, 0.05
EDGE_FACTOR = 16

_AB = A + B
_C_NORM = C / (1.0 - _AB)
_A_NORM = A / _AB


@dataclass
class EdgeList:
    """A static-shape edge list: ``src/dst`` are int32 ``[M]``."""

    src: torch.Tensor
    dst: torch.Tensor
    num_vertices: int

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def _generator(seed: int | torch.Generator, device: torch.device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def generate_edges(seed: int | torch.Generator, scale: int,
                   edge_factor: int = EDGE_FACTOR, permute: bool = False,
                   device=None) -> EdgeList:
    """Generate a Graph500 Kronecker edge list at ``scale`` (2**scale verts)."""
    device = resolve_device(device)
    gen = _generator(seed, device)
    n_vertices = 1 << scale
    n_edges = edge_factor << scale
    src = torch.zeros(n_edges, dtype=torch.int32, device=device)
    dst = torch.zeros(n_edges, dtype=torch.int32, device=device)
    for ib in range(scale):
        ii_bit = torch.rand(n_edges, generator=gen, device=device) > _AB
        thresh = torch.where(ii_bit, _C_NORM, _A_NORM)
        jj_bit = torch.rand(n_edges, generator=gen, device=device) > thresh
        src += ii_bit.to(torch.int32) << ib
        dst += jj_bit.to(torch.int32) << ib
    if permute:
        # Reference behaviour: shuffle vertex labels and edge order.
        perm = torch.randperm(n_vertices, generator=gen, device=device).to(torch.int32)
        src, dst = perm[src.long()], perm[dst.long()]
        order = torch.randperm(n_edges, generator=gen, device=device)
        src, dst = src[order], dst[order]
    return EdgeList(src=src, dst=dst, num_vertices=n_vertices)


def sample_roots(seed: int, edges: EdgeList, n_roots: int = 64) -> torch.Tensor:
    """Sample BFS roots among non-isolated vertices (Graph500 requirement):
    a random endpoint of a random edge, so every root has degree >= 1."""
    device = edges.src.device
    gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0x5EED)
    idx = torch.randint(0, edges.num_edges, (n_roots,), generator=gen, device=device)
    side = torch.rand(n_roots, generator=gen, device=device) < 0.5
    return torch.where(side, edges.src[idx], edges.dst[idx])
