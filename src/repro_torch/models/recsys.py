"""xDeepFM [1803.05170]: sparse embeddings + CIN + DNN + linear, in PyTorch.

The port of ``repro.models.recsys``, for serving and training.  Parameters
are a dict of tensors keyed by the JAX package's pytree paths (``table``
[F * R, D], field i in rows [i R, (i+1) R), ``linear`` [F * R], ``bias``,
``cin/i/w`` [H, F0, Fl], ``cin_out``, ``mlp/i/w`` [in, out] (``h @ w``),
``mlp/i/b``, ``mlp_out``), which the optimizer, the train step and the
checkpoint use as they are.  ``forward``, ``loss_fn`` and
``retrieval_scores`` are plain functions over it, as the JAX package's are
over its parameter pytree; a tensor takes part in a gradient only when the
caller asks for it (the train step does).  With ``use_cin_kernel`` the
CIN layers go through ``kernels.ops.cin_layer`` (the hand-written CUDA
kernel on the card, the plain outer-product version on the CPU), which has
no backward and refuses inputs that need a gradient; without it, through
the two-step contraction ``cin_layer_einsum``, which the JAX package leaves
to XLA and which training differentiates.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch
from torch.nn import functional as F

from repro_torch.kernels import ops
from repro_torch.util import resolve_device


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    embed_dim: int = 10
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp_layers: tuple[int, ...] = (400, 400)
    rows_per_field: int = 1 << 20    # power-law synthetic vocab per field
    n_dense: int = 0                 # the assigned config is all-sparse
    use_cin_kernel: bool = False     # fused CIN kernel (kernels.ops.cin_layer)


def cin_weights(params: Mapping) -> list:
    """The CIN layers' ``cin/i/w``, in layer order."""
    return [params[f"cin/{i}/w"] for i in range(_count(params, "cin"))]


def mlp_layers(params: Mapping) -> list:
    """The DNN layers' ``(mlp/i/w, mlp/i/b)``, in layer order."""
    return [(params[f"mlp/{i}/w"], params[f"mlp/{i}/b"])
            for i in range(_count(params, "mlp"))]


def _count(params: Mapping, name: str) -> int:
    return sum(1 for k in params if k.startswith(name + "/") and k.endswith("/w"))


# ---------------------------------------------------------------------------
# EmbeddingBag: index_select + index_add_ (multi-hot general form)
# ---------------------------------------------------------------------------

def embedding_bag(table: torch.Tensor, ids: torch.Tensor, bag_ids: torch.Tensor,
                  n_bags: int, weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """table [R, D]; ids [L]; bag_ids [L] -> [n_bags, D].

    Ragged bags are flattened with a bag-id vector; slots with
    ``bag_id == n_bags`` are dropped (they land in an extra segment)."""
    rows = table.index_select(0, ids)
    if weights is not None:
        rows = rows * weights[:, None]
    out = torch.zeros((n_bags + 1, table.shape[1]), dtype=table.dtype,
                      device=table.device).index_add_(0, bag_ids, rows)[:n_bags]
    if mode == "mean":
        cnt = torch.zeros((n_bags + 1,), dtype=table.dtype, device=table.device) \
            .index_add_(0, bag_ids, torch.ones_like(ids, dtype=table.dtype))[:n_bags]
        out = out / cnt[:, None].clamp(min=1.0)
    return out


def init_params(cfg: XDeepFMConfig, seed: int = 0, device=None,
                dtype=torch.float32) -> dict:
    """Random parameters with the JAX package's scales, drawn from an
    explicit ``torch.Generator`` on the target device (so the values differ
    from ``repro.models.recsys.init_params``), keyed by path in the JAX
    package's leaf order.  At full width the table is 39 * 2^20 x 10 fp32,
    1.64 GB."""
    device = resolve_device(device)
    gen = (None if device.type == "meta"      # param_template: shapes only
           else torch.Generator(device=device).manual_seed(seed))

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(scale)

    f, d = cfg.n_sparse, cfg.embed_dim
    rows = cfg.rows_per_field * f
    table = normal((rows, d), 0.01)
    linear = normal((rows,), 0.01)
    params = {"bias": torch.zeros((), dtype=dtype, device=device)}
    prev = f
    for i, h in enumerate(cfg.cin_layers):
        params[f"cin/{i}/w"] = normal((h, f, prev), math.sqrt(1.0 / (f * prev)))
        prev = h
    params["cin_out"] = normal((sum(cfg.cin_layers), 1), 0.01)
    params["linear"] = linear
    prev = f * d
    for i, h in enumerate(cfg.mlp_layers):
        w = normal((prev, h), math.sqrt(2.0 / prev))
        params[f"mlp/{i}/b"] = torch.zeros((h,), dtype=dtype, device=device)
        params[f"mlp/{i}/w"] = w
        prev = h
    params["mlp_out"] = normal((prev, 1), 0.01)
    params["table"] = table
    return params


def param_template(cfg: XDeepFMConfig) -> dict:
    """Each leaf's shape and dtype as :func:`init_params` gives them, keyed
    by path: tensors on the ``meta`` device (no memory, no draws)."""
    return init_params(cfg, device="meta")


def _field_ids(ids: torch.Tensor, cfg: XDeepFMConfig) -> torch.Tensor:
    """Per-field ids -> global row ids in the fused table."""
    offs = torch.arange(cfg.n_sparse, dtype=ids.dtype, device=ids.device) \
        * cfg.rows_per_field
    return ids + offs[None, :]


def cin_layer_einsum(x0: torch.Tensor, xl: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B,F0,D] x [B,Fl,D] x [H,F0,Fl] -> [B,H,D] without materializing
    the [B,F0,Fl,D] outer product (two-step contraction; its [B,H,F0,D]
    intermediate is 82 GB at B = 262,144 and full width)."""
    t = torch.einsum("hij,bjd->bhid", w, xl)
    return torch.einsum("bhid,bid->bhd", t, x0)


def embed(params: Mapping, ids: torch.Tensor, cfg: XDeepFMConfig):
    """ids [B, F] -> (global row ids [B * F], embeddings [B, F, D]).

    The lookup is ``F.embedding``, whose dense backward sums each row's
    gradients in a fixed order on the card (``index_select``'s
    accumulates with atomics), so a training step is repeatable there."""
    b, f = ids.shape
    gids = _field_ids(ids, cfg).reshape(-1)
    return gids, F.embedding(gids, params["table"]).reshape(b, f, cfg.embed_dim)


def dnn_tower(params: Mapping, h: torch.Tensor) -> torch.Tensor:
    """The DNN branch's hidden layers: relu(h @ w + b) per layer."""
    for w, bias in mlp_layers(params):
        h = torch.relu(h @ w + bias)
    return h


def cin_features(params: Mapping, emb: torch.Tensor, cfg: XDeepFMConfig) -> torch.Tensor:
    """emb [B, F, D] -> the CIN layers' outputs sum-pooled over D, [B, sum(H)]."""
    cin_fn = ops.cin_layer if cfg.use_cin_kernel else cin_layer_einsum
    xl = emb
    pooled = []
    for w in cin_weights(params):
        xl = cin_fn(emb, xl, w)                             # [B, H, D]
        pooled.append(xl.sum(-1))                           # sum-pool over D
    return torch.cat(pooled, dim=-1)


def forward(params: Mapping, ids: torch.Tensor, cfg: XDeepFMConfig) -> torch.Tensor:
    """ids [B, F] int32 per-field categorical -> logits [B]."""
    b, f = ids.shape
    gids, emb = embed(params, ids, cfg)                     # [B, F, D]

    lin = F.embedding(gids, params["linear"][:, None]).reshape(b, f).sum(-1)

    cin_logit = (cin_features(params, emb, cfg) @ params["cin_out"])[:, 0]

    h = dnn_tower(params, emb.reshape(b, f * cfg.embed_dim))
    mlp_logit = (h @ params["mlp_out"])[:, 0]

    return lin + cin_logit + mlp_logit + params["bias"]


def loss_fn(params: Mapping, ids: torch.Tensor, labels: torch.Tensor,
            cfg: XDeepFMConfig) -> torch.Tensor:
    """Mean binary cross-entropy of the logits, in the JAX package's stable
    form ``max(z, 0) - z y + log1p(exp(-|z|))``."""
    logits = forward(params, ids, cfg)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


# ---------------------------------------------------------------------------
# Retrieval scoring: one query vs n_candidates (shape cell retrieval_cand)
# ---------------------------------------------------------------------------

def retrieval_scores(params: Mapping, query_ids: torch.Tensor,
                     cand_emb: torch.Tensor, cfg: XDeepFMConfig) -> torch.Tensor:
    """query_ids [1, F]; cand_emb [N, D_sum] -> scores [N].

    The user tower reuses the DNN branch; candidates are scored with one
    batched matvec."""
    _, emb = embed(params, query_ids, cfg)
    h = dnn_tower(params, emb.reshape(1, cfg.n_sparse * cfg.embed_dim))
    return (cand_emb @ h[0]).to(torch.float32)
