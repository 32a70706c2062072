"""Carry the JAX package's arrays, given as numpy, into the port.

The same edge list (or built graph, GNN graph and sampled blocks, or
xDeepFM, LM or GNN parameter pytree and optimizer state) goes through both
packages, so their outputs can be
compared: graphs bit for bit, model outputs within a stated tolerance; the
models' parameters and AdamW state also go back, as numpy pytrees the JAX
package takes.  Bitmaps are uint32 in the
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
from repro_torch.models import gnn, transformer
from repro_torch.optim.optimizer import AdamWState, leaf_order
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
                     weight=None, edges: EdgeList | None = None,
                     device=None) -> BuiltGraph:
    """A built graph from the JAX package's arrays (as numpy).

    ``src/dst/valid`` are the ``EdgeView`` planes, ``degree`` the sorted
    degree vector and ``a_core`` (uint32 ``[K, K/32]``) the heavy core with
    ``k_heavy``/``threshold`` its statics; ``a_core=None`` builds no core.
    The halo and ``core_nnz`` follow from the edges and ``K``, as
    ``build_heavy_core`` derives them.  ``weight`` is the uint32 weight
    plane of a weighted ``EdgeView`` (carried as int64, same values), None
    for an unweighted graph.  ``edges`` is the input edge list for root
    sampling (optional).
    """
    device = resolve_device(device)
    v = int(num_vertices)
    w = None
    if weight is not None:
        w = torch.from_numpy(np.asarray(weight, np.uint32).astype(np.int64)).to(device)
    ev = EdgeView(src=_i32(src, device), dst=_i32(dst, device),
                  valid=torch.from_numpy(np.asarray(valid, bool).copy()).to(device),
                  num_vertices=v, weight=w)
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


def xdeepfm_params_from_numpy(params: dict, cfg, device=None) -> dict:
    """The JAX package's xDeepFM parameter pytree (as numpy) -> the port's
    path-keyed parameters (:func:`repro_torch.models.recsys.init_params`).

    ``params`` holds ``table``, ``linear``, ``bias``, ``cin`` (a list of
    ``{"w"}``), ``cin_out``, ``mlp`` (a list of ``{"w", "b"}``) and
    ``mlp_out``, in the JAX layouts, which the port keeps.
    """
    device = resolve_device(device)
    if [layer["w"].shape[0] for layer in params["cin"]] != list(cfg.cin_layers) or \
            [layer["w"].shape[1] for layer in params["mlp"]] != list(cfg.mlp_layers):
        raise ValueError("xdeepfm_params_from_numpy: parameter widths do not "
                         "match the config")
    flat = paths_from_tree(params)
    return {k: torch.from_numpy(np.array(flat[k], dtype=np.float32)).to(device)
            for k in leaf_order(flat)}


def lm_params_from_numpy(params: dict, cfg, device=None) -> dict:
    """The JAX package's LM parameter pytree (as numpy) -> the port's
    path-keyed parameters, each leaf with the shape and dtype
    :func:`repro_torch.models.transformer.init_params` gives it (bf16
    weights, float32 norms and router).

    The bf16 weights arrive as float32 arrays holding bf16 values (exact)
    or as uint16 bit-views (``train/checkpoint.py``'s form), so
    ``ml_dtypes`` is never needed; a float32 array that is not exactly bf16
    raises.
    """
    device = resolve_device(device)
    flat = paths_from_tree(params)
    template = transformer.param_template(cfg)
    if set(flat) != set(template) or \
            any(tuple(flat[k].shape) != tuple(t.shape) for k, t in template.items()):
        raise ValueError("lm_params_from_numpy: parameter shapes do not match the config")
    out = {}
    for k, want in template.items():
        arr = np.asarray(flat[k])
        if arr.dtype == np.uint16:
            t = torch.from_numpy(arr.astype(np.int16, copy=True)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if want.dtype != t.dtype:
            back = t.to(want.dtype)
            if not torch.equal(back.to(t.dtype), t):
                raise ValueError(f"lm_params_from_numpy: {k} is not exactly {want.dtype}")
            t = back
        out[k] = t.to(device)
    return out


def lm_params_to_numpy(params: dict) -> dict:
    """The port's path-keyed LM parameters -> the JAX package's parameter
    pytree as numpy: every leaf float32 (bf16 values exact), to be cast to
    the JAX dtypes (``jnp.asarray(a, jnp.bfloat16)``) by the caller."""
    return tree_from_paths({k: _np(t.to(torch.float32)) for k, t in params.items()})


def gnn_params_from_numpy(params: dict, arch: str, cfg, device=None) -> dict:
    """The JAX package's GNN parameter pytree (as numpy) for ``arch``
    (``gat-cora``, ``graphsage-reddit``, ``dimenet``, ``equiformer-v2``) ->
    the port's path-keyed float32 parameters; shapes that differ from the
    port's ``*_init`` at ``cfg`` raise."""
    device = resolve_device(device)
    flat = paths_from_tree(params)
    template = gnn.param_template(arch, cfg)
    if set(flat) != set(template) or \
            any(tuple(np.shape(flat[k])) != tuple(t.shape) for k, t in template.items()):
        raise ValueError(f"gnn_params_from_numpy: parameter shapes do not match "
                         f"the {arch} config")
    return {k: torch.from_numpy(np.array(flat[k], dtype=np.float32)).to(device)
            for k in leaf_order(flat)}


def gnn_params_to_numpy(params: dict) -> dict:
    """The port's path-keyed GNN parameters -> the JAX package's pytree as
    numpy."""
    return tree_from_paths({k: _np(t) for k, t in params.items()})


def graph_from_numpy(node_feat, edge_src, edge_dst, edge_valid, n_nodes: int,
                     edge_vec=None, graph_ids=None, device=None) -> gnn.Graph:
    """The JAX package's ``Graph`` fields (as numpy) -> the port's."""
    device = resolve_device(device)

    def f32(a):
        return None if a is None else \
            torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return gnn.Graph(node_feat=f32(node_feat), edge_src=_i32(edge_src, device),
                     edge_dst=_i32(edge_dst, device),
                     edge_valid=torch.from_numpy(np.array(edge_valid, bool)).to(device),
                     n_nodes=int(n_nodes), edge_vec=f32(edge_vec),
                     graph_ids=None if graph_ids is None else _i32(graph_ids, device))


def blocks_from_numpy(blocks: list, device=None) -> list:
    """The JAX sampler's blocks (``src``/``dst``/``valid`` as numpy,
    ``n_dst``) -> the port's."""
    device = resolve_device(device)
    return [{"src": _i32(b["src"], device), "dst": _i32(b["dst"], device),
             "valid": torch.from_numpy(np.array(b["valid"], bool)).to(device),
             "n_dst": int(b["n_dst"])} for b in blocks]


def paths_from_tree(tree, prefix: str = "") -> dict:
    """A nested dict / list pytree -> ``{"cin/0/w": leaf, ...}`` (the JAX
    package's pytree paths joined by ``/``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(paths_from_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_from_paths(flat: dict):
    """Inverse of :func:`paths_from_tree`: all-digit path parts are list
    indices."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def xdeepfm_params_to_numpy(params: dict) -> dict:
    """The port's path-keyed parameters -> the JAX package's parameter
    pytree as numpy (the inverse of :func:`xdeepfm_params_from_numpy`)."""
    return tree_from_paths({k: _np(t) for k, t in params.items()})


def adamw_state_to_numpy(state: AdamWState) -> tuple:
    """The port's AdamW state -> ``(step, m, v)`` as numpy, ``m``/``v`` the
    JAX package's pytrees (``repro.optim.optimizer.AdamWState(*...)``
    after ``jnp.asarray`` of each leaf)."""
    return (_np(state.step), tree_from_paths({k: _np(t) for k, t in state.m.items()}),
            tree_from_paths({k: _np(t) for k, t in state.v.items()}))


def adamw_state_from_numpy(state, device=None) -> AdamWState:
    """The JAX package's ``AdamWState`` (or a ``(step, m, v)`` triple of
    numpy pytrees) -> the port's, keyed by path."""
    device = resolve_device(device)
    step, m, v = state

    def tree(t):
        return {k: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
                for k, a in paths_from_tree(t).items()}

    return AdamWState(torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                   device=device), tree(m), tree(v))
