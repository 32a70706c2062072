"""Carry the JAX package's arrays, given as numpy, into the port.

The same edge list (or built graph, or xDeepFM parameter pytree) goes
through both packages, so their outputs can be compared: graphs bit for
bit, model outputs within a stated tolerance.  Bitmaps are uint32 in the
JAX package and int32 bit-views here (``np.ndarray.view(np.int32)``); every
other array keeps its values.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bfs_steps import EdgeView
from repro_torch.core.heavy import core_from_bitmap
from repro_torch.core.kronecker import EdgeList
from repro_torch.core.pipeline import BuiltGraph
from repro_torch.models.recsys import XDeepFM
from repro_torch.util import resolve_device


def words_to_torch(words: np.ndarray, device=None) -> torch.Tensor:
    """uint32 words -> int32 bit-view tensor (same bits)."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(resolve_device(device))


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 bit-view tensor -> uint32 words (same bits)."""
    return words.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)


def _i32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int32).copy()).to(device)


def edge_list_from_numpy(src, dst, num_vertices: int, device=None) -> EdgeList:
    """The JAX package's ``EdgeList`` (as numpy) -> the port's."""
    device = resolve_device(device)
    return EdgeList(src=_i32(src, device), dst=_i32(dst, device),
                    num_vertices=int(num_vertices))


def built_from_numpy(src, dst, valid, degree, *, num_vertices: int,
                     a_core=None, k_heavy=None, threshold: int = 100,
                     edges: EdgeList | None = None, device=None) -> BuiltGraph:
    """A built graph from the JAX package's arrays (as numpy).

    ``src/dst/valid`` are the ``EdgeView`` planes, ``degree`` the sorted
    degree vector and ``a_core`` (uint32 ``[K, K/32]``) the heavy core with
    ``k_heavy``/``threshold`` its statics; ``a_core=None`` builds no core.
    The halo and ``core_nnz`` follow from the edges and ``K``, as
    ``build_heavy_core`` derives them.  ``edges`` is the input edge list
    for root sampling (optional).
    """
    device = resolve_device(device)
    v = int(num_vertices)
    ev = EdgeView(src=_i32(src, device), dst=_i32(dst, device),
                  valid=torch.from_numpy(np.asarray(valid, bool).copy()).to(device),
                  num_vertices=v)
    core = None
    if a_core is not None:
        core = core_from_bitmap(
            words_to_torch(a_core, device),
            torch.tensor(int(k_heavy), dtype=torch.int32, device=device),
            int(threshold), ev.src, ev.dst, ev.valid, v)
    deg = _i32(degree, device)
    return BuiltGraph(ev=ev, degree=deg, core=core, reorder=None,
                      construction_s=0.0, n_vertices=v,
                      nnz=int(deg.to(torch.int64).sum()), edges=edges)


def xdeepfm_params_from_numpy(params: dict, cfg, device=None):
    """The JAX package's xDeepFM parameter pytree (as numpy) -> ``XDeepFM``.

    ``params`` holds ``table``, ``linear``, ``bias``, ``cin`` (a list of
    ``{"w"}``), ``cin_out``, ``mlp`` (a list of ``{"w", "b"}``) and
    ``mlp_out``, in the JAX layouts, which the port keeps.
    """
    device = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    cin = [t(layer["w"]) for layer in params["cin"]]
    mlp = [(t(layer["w"]), t(layer["b"])) for layer in params["mlp"]]
    if [w.shape[0] for w in cin] != list(cfg.cin_layers) or \
            [w.shape[1] for w, _ in mlp] != list(cfg.mlp_layers):
        raise ValueError("xdeepfm_params_from_numpy: parameter widths do not "
                         "match the config")
    return XDeepFM(t(params["table"]), t(params["linear"]), t(params["bias"]),
                   cin, t(params["cin_out"]), mlp, t(params["mlp_out"]))
