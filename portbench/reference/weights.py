"""The SSSP configurations' edge weights, as the configuration defines them.

A weight is a pure function of the unordered pair of (degree-sorted)
endpoint ids and the run's seed: a 32-bit finalizer hash of (min, max),
taken modulo ``max_weight`` plus one, so w(u, v) == w(v, u) and every
weight lies in [1, max_weight].  This is the definition the program's
weight plane implements; it is written out here in plain PyTorch so the
reference recomputes every weight itself.

``bits`` keeps only the top ``bits`` bits of an 8-bit weight (the others
set): the control of the SSSP cells, the int4 step below int8.
"""
from __future__ import annotations

import torch

U32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    # h * c mod 2^32 with every partial product below 2^48 (int64 holds it)
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & U32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def pair_hash(u: torch.Tensor, v: torch.Tensor, *, seed: int) -> torch.Tensor:
    """int64 in [0, 2^32): the 32-bit finalizer hash of the sorted pair
    (min(u, v), max(u, v)) and ``seed``, so symmetric in u and v."""
    a = torch.minimum(u, v).to(torch.int64) & U32
    b = torch.maximum(u, v).to(torch.int64) & U32
    h = _mix32((_mul32(a, 0x9E3779B9) + (int(seed) & U32)) & U32)
    return _mix32(h ^ _mul32(b, 0x85EBCA6B))


def edge_weights(u: torch.Tensor, v: torch.Tensor, *, seed: int, max_weight: int,
                 bits: int | None = None) -> torch.Tensor:
    """int64 weights in [1, max_weight] of the entries u -> v."""
    w = 1 + pair_hash(u, v, seed=seed) % int(max_weight)
    if bits is not None:
        w = w | ((1 << (8 - bits)) - 1)
    return w
