"""Train and serve steps for the xDeepFM workload: the port of the recsys
part of ``repro.train.train_step`` (ROADMAP Queue 1, item 12), and its
cross-entropy.

The train step is a plain function over path-keyed parameter mappings
(:func:`repro_torch.models.recsys.init_params`): gradients by
``torch.autograd``, the update by the optimizer's functional
``update(grads, state, params)``.  The data-parallel form splits the batch
over the shards of a mesh and sums the gradients with the T3 monitor psum.
"""
from __future__ import annotations

import torch

from repro_torch.comms import hierarchical as hier
from repro_torch.comms.mesh import Mesh, VertexComm
from repro_torch.models import recsys
from repro_torch.optim.optimizer import AdamW


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [..., V] fp32; labels [...] int. Mean token NLL."""
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - true)


def xdeepfm_value_and_grad(params: dict, batch: dict, cfg: recsys.XDeepFMConfig):
    """(loss, grads) of ``recsys.loss_fn`` at ``params`` (a path-keyed
    mapping, untouched) on ``batch``."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss = recsys.loss_fn(leaves, batch["ids"], batch["labels"], cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def make_xdeepfm_train_step(cfg: recsys.XDeepFMConfig, opt: AdamW):
    """step(params, opt_state, batch) -> (params, opt_state, loss): one
    optimizer step on ``batch`` (``ids`` [B, F] int32, ``labels`` [B]
    float32).  Training differentiates the einsum CIN path: with
    ``use_cin_kernel=True`` the kernel wrapper raises (it has no backward)."""
    def step(params, opt_state, batch):
        loss, grads = xdeepfm_value_and_grad(params, batch, cfg)
        new_params, new_state = opt.update(grads, opt_state, params)
        return new_params, new_state, loss

    return step


def make_xdeepfm_dp_train_step(cfg: recsys.XDeepFMConfig, opt: AdamW, mesh: Mesh):
    """The data-parallel train step over the vertex shards of a ``(group,
    member)`` mesh: shard ``d`` takes rows ``[d B/P, (d+1) B/P)`` of the
    batch, and the per-shard gradients and losses are summed over the mesh
    (``hierarchical_psum``: reduce-scatter within the group, the monitors
    across groups, gather within the group) and divided by ``P``, so the
    step equals the single-shard step on the whole batch up to the order of
    the float sums.  Every shard
    updates its own replica; the mesh's first local shard's is returned."""
    comm = VertexComm(mesh)
    p = comm.n

    def step(params, opt_state, batch):
        b = batch["ids"].shape[0]
        if b % p:
            raise ValueError(f"batch of {b} rows does not split over {p} shards")
        rows = b // p
        per = [xdeepfm_value_and_grad(
                   params, {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()}, cfg)
               for d in comm.local]
        grads = {}
        for k in per[0][1]:
            summed = hier.hierarchical_psum(comm, [g[k].reshape(-1) for _, g in per])
            grads[k] = summed[0].reshape(per[0][1][k].shape) / p
        loss = hier.hierarchical_psum(comm, [l.reshape(1) for l, _ in per])[0][0] / p
        new_params, new_state = opt.update(grads, opt_state, params)
        return new_params, new_state, loss

    return step


def make_xdeepfm_serve_step(cfg: recsys.XDeepFMConfig):
    """step(params, ids [B, F]) -> click probabilities [B]."""
    def step(params, ids: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return torch.sigmoid(recsys.forward(params, ids, cfg))
    return step


def make_retrieval_step(cfg: recsys.XDeepFMConfig):
    """step(params, query_ids [1, F], cand_emb [N, D]) -> scores [N]."""
    def step(params, query_ids: torch.Tensor,
             cand_emb: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return recsys.retrieval_scores(params, query_ids, cand_emb, cfg)
    return step
