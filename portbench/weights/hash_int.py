"""hash_int: the integer edge weights of the SSSP configurations that name
no ``weights`` (the program's own weight plane).

  weight   w(u, v) = 1 + h mod ``max_weight``, where h is the 32-bit
           finalizer hash of the sorted endpoint ids and the graph seed
           (:func:`portbench.reference.weights.edge_weights`): an integer in
           [1, max_weight], symmetric, never 0.
  control  each weight keeps its top 4 bits, the others set: the int4 step
           below 8-bit weights.
  planes   the program's weight plane holds the weights, its answer plane the
           distances, -1 where a vertex is unreached; both read as int64.

The program takes ``max_weight`` from the configuration's top level.
"""
from __future__ import annotations

import torch

from portbench.reference.weights import edge_weights

#: No weight is 0, so a parent that passes the local test lies strictly
#: nearer the key and the parents form a tree.
ZERO_WEIGHTS = False


def reference(u: torch.Tensor, v: torch.Tensor, *, seed: int, doc: dict,
              control: bool = False) -> torch.Tensor:
    """int64 weights of the entries u -> v."""
    return edge_weights(u, v, seed=seed, max_weight=doc["max_weight"],
                        bits=4 if control else None)


def decode_weights(plane: torch.Tensor) -> torch.Tensor:
    return plane.to(torch.int64)


def decode_distances(level: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dist, reached)`` of the program's answer plane."""
    dist = level.to(torch.int64)
    return dist, dist != -1


def encode_weights(w: torch.Tensor) -> torch.Tensor:
    """The reference's weights as the program's plane (the control's
    outputs): the integers themselves."""
    return w


def encode_distances(dist: torch.Tensor) -> torch.Tensor:
    """The reference's distances (-1 unreached) as the program's plane."""
    return dist


def program_kw(doc: dict) -> dict:
    return {"max_weight": doc["max_weight"]}
