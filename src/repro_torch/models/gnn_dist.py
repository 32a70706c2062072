"""Distributed full-graph GraphSAGE: the owner-partitioned step over the T3
monitor all-gather (the port of ``repro.models.gnn_dist``).

  * nodes are owner-partitioned [N_loc, F] in contiguous blocks;
  * edges are partitioned by DST owner (each shard aggregates into its own
    rows — nothing is scattered remotely; :func:`partition_edges`);
  * ONE hierarchical (monitor, T3) all-gather of node features per layer —
    the only collective; link bytes = N x F x 4 x (P-1)/P per shard
    instead of per-edge traffic.

``gather_dtype=torch.bfloat16`` runs the whole layer pipeline in bf16, so
the gather moves half the bytes (the loss is taken in float32).

The shards of a ``(group, member)`` mesh (``comms.mesh``) run in one
lockstep host loop, as the data-parallel xDeepFM step does; a process mesh
is refused.  Each shard holds its own replica of the parameters, and the
step builds one autograd graph over every shard: a shard's gathered
features are ``torch.cat`` of every shard's rows, so one backward pass of
the global loss hands each replica its local partial gradient with the
cotangents of its rows summed over the shards that gathered them (the
gather's transpose, a reduce-scatter).  The replicas' gradients are then
summed with the monitor psum, which gives the gradient of the global mean
NLL, the single-device step's.  (The JAX package's step hands each shard
the gradient of the psum of the shard losses, P times that; AdamW's first
step hides the factor, SGD shows it.)
"""
from __future__ import annotations

import math

import torch

from repro_torch.comms import hierarchical as hier
from repro_torch.comms.mesh import Mesh, VertexComm
from repro_torch.models.gnn import sage_layer
from repro_torch.optim.optimizer import AdamW
from repro_torch.train.train_step import softmax_xent


def sage_layer_local(p, h_full, h_own, src, dst_local, valid, n_loc, last):
    """One SAGE layer on the owner shard.

    h_full: [N, F] gathered features; h_own: [N_loc, F] owned rows;
    src: global ids of edge sources; dst_local: local row of edge target.
    """
    return sage_layer(p, h_full, h_own, src, dst_local, valid, n_loc, last)


#: a shard's edge block is padded to a multiple of this many slots
ALIGN = 128


def partition_edges(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                    n_nodes: int, n_shards: int):
    """Edges partitioned by destination owner, as the step takes them:
    ``(src, dst_local, valid)``, each [n_shards * cap], shard ``d``'s block
    ``[d cap, (d+1) cap)`` holding the valid edges into its rows ``[d N_loc,
    (d+1) N_loc)`` in input order, padded with ``(n_nodes, 0, False)``;
    ``cap`` is the largest shard's count rounded up to :data:`ALIGN` (the
    layout of the JAX package's test)."""
    n_loc = n_nodes // n_shards
    owner = torch.where(valid, dst.long() // n_loc, n_shards)
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner[valid], minlength=n_shards)
    cap = max(1, math.ceil(int(counts.max()) / ALIGN)) * ALIGN
    o = owner[order]
    keep = o < n_shards
    o, order = o[keep], order[keep]
    start = torch.cumsum(counts, 0) - counts
    slot = o * cap + torch.arange(o.shape[0], device=o.device) - start[o]
    total = n_shards * cap
    s = torch.full((total,), n_nodes, dtype=torch.int32, device=src.device)
    d = torch.zeros((total,), dtype=torch.int32, device=src.device)
    v = torch.zeros((total,), dtype=torch.bool, device=src.device)
    s[slot] = src[order].to(torch.int32)
    d[slot] = (dst[order].long() % n_loc).to(torch.int32)
    v[slot] = True
    return s, d, v


def make_sage_dist_step(cfg, opt: AdamW, mesh: Mesh, n_nodes: int, *,
                        hierarchical: bool = True, gather_dtype=torch.float32,
                        keep_padding: bool = False):
    """Owner-partitioned full-graph SAGE train step over the vertex shards
    of a ``(group, member)`` mesh (flat shard order = owner order).

    step(params, opt_state, feats [N, F], src, dst_local, valid, labels [N])
    -> (params, opt_state, loss): ``feats`` and ``labels`` split in dim 0
    over the shards, the edge arrays as :func:`partition_edges` gives them;
    ``loss`` is the mean NLL over every node (the shards' pmean).
    ``hierarchical`` picks the monitor all-gather (T3) or the flat one.
    ``keep_padding`` runs every shard's whole padded edge block, as the JAX
    package's static shapes do (the dry run's shape-only step, which cannot
    find the valid edges on the ``meta`` device); by default each shard's
    padding is dropped.
    """
    comm = VertexComm(mesh)
    if comm.distributed:
        raise ValueError("make_sage_dist_step runs on a virtual or device mesh, "
                         "not on a process mesh")
    p_n = comm.n
    if n_nodes % p_n:
        raise ValueError(f"{n_nodes} nodes do not split over {p_n} shards")
    n_loc = n_nodes // p_n
    gather = hier.hierarchical_all_gather if hierarchical else hier.flat_all_gather

    def rows(t, d, k):
        return t[d * k:(d + 1) * k]

    def shard_edges(src, dst_local, valid):
        """Each local shard's valid edges, in their order: the padding adds
        zero rows to the dropped segment, so leaving it out changes no sum
        and keeps a skewed shard's padding out of every [E, F] gather."""
        e_loc = src.shape[0] // p_n
        if keep_padding:
            return [(rows(src, d, e_loc), rows(dst_local, d, e_loc), rows(valid, d, e_loc))
                    for d in comm.local]
        out = []
        for d in comm.local:
            keep = torch.nonzero(rows(valid, d, e_loc)).squeeze(1)
            out.append((rows(src, d, e_loc)[keep], rows(dst_local, d, e_loc)[keep],
                        rows(valid, d, e_loc)[keep]))
        return out

    def shard_loss(replicas, feats, edges, labels):
        hs = [rows(feats, d, n_loc).to(gather_dtype) for d in comm.local]
        for i in range(cfg.n_layers):
            last = i == cfg.n_layers - 1
            # T3: one (monitor-hierarchical) gather of the current features
            fulls = gather(comm, hs)
            hs = [sage_layer_local(
                      {k: rep[f"layers/{i}/{k}"].to(gather_dtype) for k in ("w_self", "w_neigh")},
                      full, h, *e, n_loc, last)
                  for rep, full, h, e in zip(replicas, fulls, hs, edges)]
        return [softmax_xent(h.to(torch.float32), rows(labels, d, n_loc))
                for h, d in zip(hs, comm.local)]

    def step(params, opt_state, feats, src, dst_local, valid, labels):
        if feats.shape[0] != n_nodes:
            raise ValueError(f"feats has {feats.shape[0]} rows, the step {n_nodes}")
        replicas = [{k: p.detach().requires_grad_(True) for k, p in params.items()}
                    for _ in comm.local]
        edges = shard_edges(src, dst_local, valid)
        with torch.enable_grad():
            nlls = shard_loss(replicas, feats, edges, labels)
            total = torch.stack(nlls).sum() / p_n
            flat = torch.autograd.grad(
                total, [p for rep in replicas for p in rep.values()],
                allow_unused=True, materialize_grads=True)
        keys, k_n = list(params), len(params)
        grads = {}
        for j, k in enumerate(keys):
            per = [flat[r * k_n + j].reshape(-1) for r in range(len(replicas))]
            grads[k] = hier.hierarchical_psum(comm, per)[0].reshape(params[k].shape)
        loss = hier.hierarchical_psum(comm, [l.detach().reshape(1) for l in nlls])[0][0]
        loss = loss / torch.tensor(p_n, dtype=loss.dtype, device=loss.device)
        new_params, new_state = opt.update(grads, opt_state, params)
        return new_params, new_state, loss

    return step
