"""uniform_f32: the Graph500 specification's Kernel 3 weights, uniform reals
in [0, 1), held at float32's 24 bits.

  weight   w(u, v) = (h >> 8) * 2^-24 as float32, where h is the 32-bit
           finalizer hash of the sorted endpoint ids and the graph seed
           (:func:`portbench.reference.weights.pair_hash`, the hash of
           ``hash_int``): symmetric, a multiple of 2^-24 in [0, 1 - 2^-24],
           and 0 on about one edge in 2^24.
  control  each weight rounded to bfloat16 (to nearest, ties to even): the
           step below float32.
  planes   the program's weight plane and answer plane hold float32 bit
           patterns in int32; -1, a NaN pattern, marks an unreached vertex.
  sums     a distance is the minimum over the paths from the key of the
           path's float32 fold, each edge one float32 add rounded to nearest
           (:mod:`portbench.bench.compare` says why this is exact).

The departure from the specification: the specification draws each weight
from its random number generator; here the hash stands in for it, as it does
for ``hash_int``, so the reference recomputes every weight from the seed.
The program's knob for these weights belongs in the configuration's
``program`` block, so :func:`program_kw` adds nothing.
"""
from __future__ import annotations

import torch

from portbench.reference.weights import pair_hash

#: A weight can be 0: two vertices at one distance joined by a zero-weight
#: edge pass the local parent test both ways, so the parents' chains are
#: checked to reach the key.
ZERO_WEIGHTS = True
UNREACHED = -1


def reference(u: torch.Tensor, v: torch.Tensor, *, seed: int, doc: dict,
              control: bool = False) -> torch.Tensor:
    """float32 weights of the entries u -> v."""
    w = (pair_hash(u, v, seed=seed) >> 8).to(torch.float32) * 2.0 ** -24
    return w.to(torch.bfloat16).to(torch.float32) if control else w


def decode_weights(plane: torch.Tensor) -> torch.Tensor:
    return plane.to(torch.int32).view(torch.float32)


def decode_distances(level: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dist, reached)`` of the program's answer plane."""
    bits = level.to(torch.int32)
    return bits.view(torch.float32), bits != UNREACHED


def encode_weights(w: torch.Tensor) -> torch.Tensor:
    """The reference's weights as the program's plane (the control's outputs)."""
    return w.contiguous().view(torch.int32)


def encode_distances(dist: torch.Tensor) -> torch.Tensor:
    """The reference's distances (+inf unreached) as the program's plane."""
    return torch.where(torch.isinf(dist), UNREACHED, dist.contiguous().view(torch.int32))


def program_kw(doc: dict) -> dict:
    return {}
