"""xDeepFM [1803.05170]: sparse embeddings + CIN + DNN + linear, in PyTorch.

The port of ``repro.models.recsys`` (serving only).  Parameters live in an
``XDeepFM`` module; ``forward`` and ``retrieval_scores`` are plain functions
over it, as the JAX package's are over its parameter pytree, and keep its
layouts: ``mlp[i].w`` is [in, out] (``h @ w``) and ``cin[i]`` is
[H, F0, Fl].  With ``use_cin_kernel`` the CIN layers go through
``kernels.ops.cin_layer`` (the hand-written CUDA kernel on the card, the
plain outer-product version on the CPU); without it, through the two-step
contraction ``cin_layer_einsum``, which the JAX package leaves to XLA.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

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


class XDeepFM(nn.Module):
    """xDeepFM parameters (the JAX package's pytree as a module).

    table [F * R, D] (field i uses rows [i R, (i+1) R)), linear [F * R],
    bias [], cin[i] [H_i, F, H_{i-1}], cin_out [sum H, 1],
    mlp[i] = (w [in, out], b [out]), mlp_out [last, 1].
    """

    def __init__(self, table, linear, bias, cin, cin_out, mlp, mlp_out):
        super().__init__()
        p = lambda t: nn.Parameter(t, requires_grad=False)
        self.table, self.linear, self.bias = p(table), p(linear), p(bias)
        self.cin = nn.ParameterList([p(w) for w in cin])
        self.cin_out = p(cin_out)
        self.mlp_w = nn.ParameterList([p(w) for w, _ in mlp])
        self.mlp_b = nn.ParameterList([p(b) for _, b in mlp])
        self.mlp_out = p(mlp_out)

    @property
    def mlp(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        return list(zip(self.mlp_w, self.mlp_b))


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
                dtype=torch.float32) -> XDeepFM:
    """Random parameters with the JAX package's scales, drawn from an
    explicit ``torch.Generator`` on the target device (so the values differ
    from ``repro.models.recsys.init_params``).  At full width the table is
    39 * 2^20 x 10 fp32, 1.64 GB."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(scale)

    f, d = cfg.n_sparse, cfg.embed_dim
    rows = cfg.rows_per_field * f
    table = normal((rows, d), 0.01)
    linear = normal((rows,), 0.01)
    cin, prev = [], f
    for h in cfg.cin_layers:
        cin.append(normal((h, f, prev), math.sqrt(1.0 / (f * prev))))
        prev = h
    cin_out = normal((sum(cfg.cin_layers), 1), 0.01)
    mlp, prev = [], f * d
    for h in cfg.mlp_layers:
        mlp.append((normal((prev, h), math.sqrt(2.0 / prev)),
                    torch.zeros((h,), dtype=dtype, device=device)))
        prev = h
    mlp_out = normal((prev, 1), 0.01)
    return XDeepFM(table, linear, torch.zeros((), dtype=dtype, device=device),
                   cin, cin_out, mlp, mlp_out)


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


def embed(params: XDeepFM, ids: torch.Tensor, cfg: XDeepFMConfig):
    """ids [B, F] -> (global row ids [B * F], embeddings [B, F, D])."""
    b, f = ids.shape
    gids = _field_ids(ids, cfg).reshape(-1)
    return gids, params.table.index_select(0, gids).reshape(b, f, cfg.embed_dim)


def dnn_tower(params: XDeepFM, h: torch.Tensor) -> torch.Tensor:
    """The DNN branch's hidden layers: relu(h @ w + b) per layer."""
    for w, bias in params.mlp:
        h = torch.relu(h @ w + bias)
    return h


def cin_features(params: XDeepFM, emb: torch.Tensor, cfg: XDeepFMConfig) -> torch.Tensor:
    """emb [B, F, D] -> the CIN layers' outputs sum-pooled over D, [B, sum(H)]."""
    cin_fn = ops.cin_layer if cfg.use_cin_kernel else cin_layer_einsum
    xl = emb
    pooled = []
    for w in params.cin:
        xl = cin_fn(emb, xl, w)                             # [B, H, D]
        pooled.append(xl.sum(-1))                           # sum-pool over D
    return torch.cat(pooled, dim=-1)


def forward(params: XDeepFM, ids: torch.Tensor, cfg: XDeepFMConfig) -> torch.Tensor:
    """ids [B, F] int32 per-field categorical -> logits [B]."""
    b, f = ids.shape
    gids, emb = embed(params, ids, cfg)                     # [B, F, D]

    lin = params.linear.index_select(0, gids).reshape(b, f).sum(-1)

    cin_logit = (cin_features(params, emb, cfg) @ params.cin_out)[:, 0]

    h = dnn_tower(params, emb.reshape(b, f * cfg.embed_dim))
    mlp_logit = (h @ params.mlp_out)[:, 0]

    return lin + cin_logit + mlp_logit + params.bias


# ---------------------------------------------------------------------------
# Retrieval scoring: one query vs n_candidates (shape cell retrieval_cand)
# ---------------------------------------------------------------------------

def retrieval_scores(params: XDeepFM, query_ids: torch.Tensor,
                     cand_emb: torch.Tensor, cfg: XDeepFMConfig) -> torch.Tensor:
    """query_ids [1, F]; cand_emb [N, D_sum] -> scores [N].

    The user tower reuses the DNN branch; candidates are scored with one
    batched matvec."""
    _, emb = embed(params, query_ids, cfg)
    h = dnn_tower(params, emb.reshape(1, cfg.n_sparse * cfg.embed_dim))
    return (cand_emb @ h[0]).to(torch.float32)
