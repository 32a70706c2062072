"""Train and serve steps for the LM and xDeepFM workloads: the port of the
LM and recsys parts of ``repro.train.train_step`` (ROADMAP Queue 1, item
12), and its cross-entropy.

The train steps are plain functions over path-keyed parameter mappings
(:func:`repro_torch.models.transformer.init_params`,
:func:`repro_torch.models.recsys.init_params`): gradients by
``torch.autograd``, the update by the optimizer's functional
``update(grads, state, params)``.  The xDeepFM data-parallel form splits the
batch over the shards of a mesh and sums the gradients with the T3 monitor
psum.  The serve and prefill steps run without autograd.
"""
from __future__ import annotations

import torch

from repro_torch.comms import hierarchical as hier
from repro_torch.comms.mesh import Mesh, VertexComm
from repro_torch.models import gnn, recsys, transformer
from repro_torch.optim.optimizer import AdamW


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [..., V] fp32; labels [...] int. Mean token NLL."""
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - true)


def _value_and_grad(loss_fn, params: dict, *args):
    """(loss, grads) of ``loss_fn(params, *args)`` at ``params`` (a
    path-keyed mapping, untouched).  A parameter the loss does not use
    (EquiformerV2's ``w_val``) gets a zero gradient, as in JAX."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves, *args)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


def _train_step(loss_fn, opt: AdamW):
    """step(params, opt_state, *args) -> (params, opt_state, loss): one
    optimizer step on the gradient of ``loss_fn(params, *args)``."""
    def step(params, opt_state, *args):
        loss, grads = _value_and_grad(loss_fn, params, *args)
        new_params, new_state = opt.update(grads, opt_state, params)
        return new_params, new_state, loss

    return step


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def make_lm_loss(cfg: transformer.LMConfig, policy=transformer.REPLICATED,
                 aux_weight: float = 0.01):
    """loss_fn(params, batch): mean token NLL of ``batch["labels"]`` under
    the logits of ``batch["tokens"]``, plus ``aux_weight`` x the MoE aux
    loss."""
    def loss_fn(params, batch):
        logits, aux = transformer.forward(params, batch["tokens"], cfg, policy)
        return softmax_xent(logits, batch["labels"]) + aux_weight * aux
    return loss_fn


def lm_value_and_grad(params: dict, batch: dict, cfg: transformer.LMConfig,
                      policy=transformer.REPLICATED, aux_weight: float = 0.01):
    """(loss, grads) of :func:`make_lm_loss` at ``params`` on ``batch``
    (``jax.value_and_grad(make_lm_loss(cfg))``); each gradient has its
    parameter's dtype."""
    return _value_and_grad(make_lm_loss(cfg, policy, aux_weight), params, batch)


def make_lm_train_step(cfg: transformer.LMConfig, opt: AdamW,
                       policy=transformer.REPLICATED, aux_weight: float = 0.01):
    """step(params, opt_state, batch) -> (params, opt_state, loss)."""
    return _train_step(make_lm_loss(cfg, policy, aux_weight), opt)


def make_lm_serve_step(cfg: transformer.LMConfig, policy=transformer.REPLICATED):
    """Greedy single-token decode step (the decode_*/long_* shape cells):
    step(params, cache, tokens [B, 1], pos) -> (next tokens [B, 1] int32,
    cache), the lowest index among equal top logits.  The cache is updated
    in place (:func:`transformer.decode_step`)."""
    def step(params, cache, tokens, pos):
        with torch.no_grad():
            logits, cache = transformer.decode_step(params, cache, tokens, pos, cfg, policy)
            return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache

    return step


def make_lm_prefill(cfg: transformer.LMConfig, policy=transformer.REPLICATED):
    """Full-sequence forward (prefill_* cells): step(params, tokens [B, S])
    -> the last position's logits [B, V] float32 (the only position whose
    logits are computed)."""
    def step(params, tokens):
        with torch.no_grad():
            x, _ = transformer.hidden_states(params, tokens, cfg, policy)
            return transformer.final_logits(params, x[:, -1], cfg)

    return step


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def make_gnn_train_step(arch: str, cfg, opt: AdamW):
    """step(params, opt_state, g, labels, mask=None) -> (params, opt_state,
    loss): full-graph GAT (``arch="gat"``) or GraphSAGE (``"sage"``), mean
    NLL over every node (``mask`` is unused, as in JAX)."""
    forward = {"gat": gnn.gat_forward, "sage": gnn.sage_forward}.get(arch)
    if forward is None:
        raise ValueError(arch)

    def loss_fn(params, g, labels, mask=None):
        return softmax_xent(forward(params, g, cfg).to(torch.float32), labels)

    return _train_step(loss_fn, opt)


def make_sage_block_train_step(cfg: gnn.SAGEConfig, opt: AdamW):
    """step(params, opt_state, feats, blocks, labels): GraphSAGE on sampled
    blocks (``data.sampler``), mean NLL over the seeds."""
    def loss_fn(params, feats, blocks, labels):
        logits = gnn.sage_forward_blocks(params, feats, blocks, cfg)
        return softmax_xent(logits.to(torch.float32), labels)

    return _train_step(loss_fn, opt)


def make_dimenet_train_step(cfg: gnn.DimeNetConfig, opt: AdamW, n_graphs: int):
    """step(params, opt_state, g, species, triplets, targets): mean squared
    error of the per-graph energies."""
    def loss_fn(params, g, species, triplets, targets):
        e = gnn.dimenet_energy(params, g, species, triplets, cfg, n_graphs)
        return torch.mean(torch.square(e[:, 0] - targets))

    return _train_step(loss_fn, opt)


def make_equiformer_train_step(cfg: gnn.EquiformerConfig, opt: AdamW):
    """step(params, opt_state, g, species, targets): mean squared error of
    the per-node predictions."""
    def loss_fn(params, g, species, targets):
        out = gnn.equiformer_forward(params, g, species, cfg)
        return torch.mean(torch.square(out[:, 0] - targets))

    return _train_step(loss_fn, opt)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def xdeepfm_value_and_grad(params: dict, batch: dict, cfg: recsys.XDeepFMConfig):
    """(loss, grads) of ``recsys.loss_fn`` at ``params`` (a path-keyed
    mapping, untouched) on ``batch``."""
    return _value_and_grad(lambda p: recsys.loss_fn(p, batch["ids"], batch["labels"], cfg),
                           params)


def make_xdeepfm_train_step(cfg: recsys.XDeepFMConfig, opt: AdamW):
    """step(params, opt_state, batch) -> (params, opt_state, loss): one
    optimizer step on ``batch`` (``ids`` [B, F] int32, ``labels`` [B]
    float32).  Training differentiates the einsum CIN path: with
    ``use_cin_kernel=True`` the kernel wrapper raises (it has no backward)."""
    return _train_step(lambda p, batch: recsys.loss_fn(p, batch["ids"], batch["labels"], cfg),
                       opt)


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
