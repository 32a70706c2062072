"""Decoder-only transformer LM (dense + MoE): the port of
``repro.models.transformer``.

Covers the five LM architectures of ``configs/lm_archs.py``:
  starcoder2-15b  GQA(48q/4kv) + GELU MLP + layernorm
  minicpm-2b      MHA(36)      + SwiGLU   + rmsnorm (WSD schedule in optim)
  olmo-1b         MHA(16)      + SwiGLU   + non-parametric LN
  moonshot-v1-16b-a3b  GQA + MoE 64e top-6
  granite-moe-1b-a400m GQA(16q/8kv) + MoE 32e top-8

Parameters are a mapping keyed by the JAX package's pytree paths
(``embed``, ``layers/attn/wq``, ``layers/norm1/scale``, ``layers/moe/router``,
``final_norm/scale``, ``lm_head``), which the optimizer, the train step and
the checkpoint use as they are.  Layer parameters are stacked ``[L, ...]``
and a Python loop over the layers takes the place of ``lax.scan``; with
``ShardingPolicy.remat`` each block is recomputed in the backward
(``torch.utils.checkpoint``, non-reentrant).  Weights are bf16, the norms
float32, the router float32; logits are float32 products of the bf16
operands.

A :class:`ShardingPolicy` carries what changes the computation: ``remat``,
``q_chunk`` and the MoE dispatch (``moe_mode`` over ``mesh`` /
``batch_axes``, a virtual :class:`~repro_torch.comms.mesh.Mesh`).  JAX's
activation sharding hints (``sequence_sharded``, ``unroll_layers``) change
nothing here and have no counterpart; :func:`param_shardings` /
:func:`cache_shardings` give JAX's partition specs as per-dimension
axis-name tuples (layout metadata only).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Optional

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.comms.mesh import Mesh, VertexComm
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.optim.optimizer import leaf_order
from repro_torch.util import resolve_device

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    norm: str = "rmsnorm"            # rmsnorm | layernorm | nonparametric_ln
    mlp: str = "swiglu"              # swiglu | gelu
    rope_theta: float = 10000.0
    tied_embeddings: bool = True
    # MoE (None => dense)
    n_experts: Optional[int] = None
    top_k: Optional[int] = None
    capacity_factor: float = 1.25
    # serving
    window: Optional[int] = None     # sliding-window mode (beyond-spec)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts is not None

    @property
    def attn_dims(self) -> L.AttnDims:
        return L.AttnDims(self.d_model, self.n_heads, self.n_kv_heads, self.head_dim)

    @property
    def moe_dims(self) -> M.MoEDims:
        return M.MoEDims(self.d_model, self.d_ff, self.n_experts, self.top_k,
                         self.capacity_factor, self.mlp)

    def _attn_params(self) -> int:
        d, h, hk, dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        return d * h * dh + 2 * d * hk * dh + h * dh * d

    def _ffn_params(self, experts: int) -> int:
        return experts * self.d_model * self.d_ff * (3 if self.mlp == "swiglu" else 2)

    def _embed_params(self) -> int:
        return self.vocab * self.d_model * (1 if self.tied_embeddings else 2)

    def param_count(self) -> int:
        """Weights of the attention and FFN blocks and the embeddings (the
        router included, the norms not), as the JAX package counts them."""
        if self.is_moe:
            per_ff = self._ffn_params(self.n_experts) + self.d_model * self.n_experts
        else:
            per_ff = self._ffn_params(1)
        return self.n_layers * (self._attn_params() + per_ff) + self._embed_params()

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        ff = self._ffn_params(self.top_k) + self.d_model * self.n_experts
        return self.n_layers * (self._attn_params() + ff) + self._embed_params()


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """What changes the computation: ``remat`` (recompute each block in the
    backward), ``q_chunk`` (exact query-chunked attention) and the MoE
    dispatch ``moe_mode``: ``"dense"``, ``"local_tp"`` (on a mesh with the
    ``batch_axes`` and ``model_axis``) or ``"monitor_a2a"`` (on a
    ``("group", "member")`` mesh, both batch axes).  Without a ``mesh``
    every mode is the dense dispatch, as in the JAX package."""

    mesh: Optional[Mesh] = None
    batch_axes: tuple[str, ...] = ("data",)
    model_axis: Optional[str] = "model"
    remat: bool = True
    moe_mode: str = "dense"
    q_chunk: Optional[int] = None


REPLICATED = ShardingPolicy()


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _paths(prefix: str, tree: dict) -> dict:
    return {f"{prefix}/{k}": v for k, v in tree.items()}


def init_params(cfg: LMConfig, seed: int = 0, device=None,
                dtype=torch.bfloat16) -> dict:
    """Random parameters with the JAX package's distributions and dtypes
    (bf16 weights, float32 norms and router), drawn from an explicit
    ``torch.Generator`` on the target device (so the values differ from
    ``repro.models.transformer.init_params``), keyed by path in the JAX
    package's leaf order.  olmo-1b: 1.18e9 parameters, 2.36 GB in bf16."""
    device = resolve_device(device)
    return _init(cfg, torch.Generator(device=device).manual_seed(seed), device, dtype)


def param_template(cfg: LMConfig) -> dict:
    """Each leaf's shape and dtype as :func:`init_params` gives them, keyed
    by path: tensors on the ``meta`` device (no memory, no draws)."""
    return _init(cfg, torch.Generator(), torch.device("meta"), torch.bfloat16)


def _init(cfg: LMConfig, gen: torch.Generator, device, dtype) -> dict:
    d, n = cfg.d_model, (cfg.n_layers,)
    params = {"embed": L.normal(gen, (cfg.vocab, d), 0.02, dtype, device)}
    params.update(_paths("final_norm", L.init_norm(cfg.norm, d, device=device)))
    params.update(_paths("layers/attn", L.init_attention(gen, cfg.attn_dims, stack=n,
                                                         dtype=dtype, device=device)))
    if cfg.is_moe:
        params.update(_paths("layers/moe", M.init_moe(gen, cfg.moe_dims, stack=n,
                                                      dtype=dtype, device=device)))
    else:
        params.update(_paths("layers/mlp", L.init_mlp(gen, d, cfg.d_ff, cfg.mlp, stack=n,
                                                      dtype=dtype, device=device)))
    for name in ("norm1", "norm2"):
        params.update(_paths(f"layers/{name}",
                             L.init_norm(cfg.norm, d, stack=n, device=device)))
    if not cfg.tied_embeddings:
        params["lm_head"] = L.normal(gen, (d, cfg.vocab), 1.0 / d ** 0.5, dtype, device)
    return {k: params[k] for k in leaf_order(params)}


def _norm_spec(kind: str, *lead) -> dict:
    if kind == "rmsnorm":
        return {"scale": lead + (None,)}
    if kind == "layernorm":
        return {"scale": lead + (None,), "bias": lead + (None,)}
    return {}


def param_shardings(cfg: LMConfig, policy: ShardingPolicy) -> dict:
    """JAX's Megatron TP layout of :func:`init_params`' leaves, keyed by
    path: one entry per dimension, the mesh axis it splits over or None
    (the tuple of ``PartitionSpec(...)``).  Layout metadata: the port runs
    on one device and shards nothing by it."""
    mp = policy.model_axis
    out = {"embed": (mp, None), **_paths("final_norm", _norm_spec(cfg.norm))}
    out.update(_paths("layers/attn", {"wq": (None, None, mp), "wk": (None, None, mp),
                                      "wv": (None, None, mp), "wo": (None, mp, None)}))
    for name in ("norm1", "norm2"):
        out.update(_paths(f"layers/{name}", _norm_spec(cfg.norm, None)))
    if cfg.is_moe:
        moe = {"router": (None, None, None), "w_in": (None, mp, None, None),
               "w_out": (None, mp, None, None)}
        if cfg.mlp == "swiglu":
            moe["w_gate"] = (None, mp, None, None)
        out.update(_paths("layers/moe", moe))
    else:
        mlp = {"w_in": (None, None, mp), "w_out": (None, mp, None)}
        if cfg.mlp == "swiglu":
            mlp["w_gate"] = (None, None, mp)
        out.update(_paths("layers/mlp", mlp))
    if not cfg.tied_embeddings:
        out["lm_head"] = (None, mp)
    return out


def _sub(p: Mapping, prefix: str) -> dict:
    """The entries of ``p`` under ``prefix/``, keyed by the rest of the path."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + "/")}


def _layers(params: Mapping) -> list:
    """Per layer, its parameters (``attn/wq``, ...): the stacked leaves
    unbound along dim 0 (one ``stack`` in the backward, not one
    full-size gradient per layer)."""
    stacked = _sub(params, "layers")
    slices = {k: v.unbind(0) for k, v in stacked.items()}
    n = len(next(iter(slices.values())))
    return [{k: s[i] for k, s in slices.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _block(cfg: LMConfig, policy: ShardingPolicy, x, lp, positions):
    h = L.apply_norm(cfg.norm, x, _sub(lp, "norm1"))
    h = L.attention(_sub(lp, "attn"), h, cfg.attn_dims, positions=positions,
                    rope_theta=cfg.rope_theta, window=cfg.window,
                    q_chunk=policy.q_chunk)
    x = x + h
    h = L.apply_norm(cfg.norm, x, _sub(lp, "norm2"))
    if cfg.is_moe:
        moe_p = _sub(lp, "moe")
        if policy.moe_mode == "local_tp" and policy.mesh is not None:
            h, aux = _moe_local_tp_sharded(cfg, policy, h, moe_p)
        elif policy.moe_mode == "monitor_a2a" and policy.mesh is not None:
            h, aux = _moe_monitor_sharded(cfg, policy, h, moe_p)
        else:
            h, aux = M.moe_ffn(moe_p, h, cfg.moe_dims)
    else:
        h, aux = L.mlp(_sub(lp, "mlp"), h, cfg.mlp), torch.zeros((), dtype=F32,
                                                                 device=x.device)
    return x + h, aux


def _virtual(mesh: Mesh) -> None:
    if mesh.distributed or len(set(mesh.devices)) > 1:
        raise ValueError("the sharded MoE dispatch runs on a virtual mesh (every "
                         "shard on one device)")


def _split_batch(h: torch.Tensor, n: int) -> list:
    if h.shape[0] % n:
        raise ValueError(f"batch of {h.shape[0]} does not split over {n} shards")
    return list(h.chunk(n))


def _moe_local_tp_sharded(cfg: LMConfig, policy: ShardingPolicy, h, moe_p):
    """The ``local_tp`` dispatch on ``policy.mesh``: the batch split over
    the batch axes, each data shard through :func:`moe.moe_ffn_local_tp`
    over the ``model`` axis; the aux loss is the mean over the data
    shards (JAX's pmean)."""
    mesh = policy.mesh
    _virtual(mesh)
    n_data = 1
    for a in policy.batch_axes:
        n_data *= mesh.size(a)
    outs, auxes = zip(*(M.moe_ffn_local_tp(moe_p, hh, cfg.moe_dims,
                                           model_shards=mesh.size(policy.model_axis))
                        for hh in _split_batch(h, n_data)))
    return torch.cat(outs), torch.stack(auxes).sum() / n_data


def _moe_monitor_sharded(cfg: LMConfig, policy: ShardingPolicy, h, moe_p):
    """The ``monitor_a2a`` dispatch (paper T3) on a ``("group", "member")``
    mesh: the batch split over both axes (group-major), tokens to their
    experts' owners and back through the two-phase all-to-all; the aux loss
    is the mean over the shards."""
    mesh = policy.mesh
    _virtual(mesh)
    ba = policy.batch_axes
    if len(ba) < 2 or (ba[0], ba[-1]) != ("group", "member") or \
            tuple(mesh.axis_names) != ("group", "member"):
        raise ValueError(f"monitor_a2a needs batch axes ('group', 'member') on a "
                         f"('group', 'member') mesh, got {ba} on {mesh.axis_names}")
    comm = VertexComm(mesh)
    outs, auxes = M.moe_ffn_monitor(moe_p, _split_batch(h, comm.n), cfg.moe_dims,
                                    comm=comm)
    return torch.cat(outs), torch.stack(auxes).sum() / comm.n


def final_logits(params: Mapping, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """float32 logits of the final-normed activations ``x`` [..., D]: bf16
    operands upcast, contracted in float32."""
    x = L.apply_norm(cfg.norm, x, _sub(params, "final_norm"))
    head = params["embed"].T if cfg.tied_embeddings else params["lm_head"]
    return x.to(F32) @ head.to(F32)


def hidden_states(params: Mapping, tokens: torch.Tensor, cfg: LMConfig,
                  policy: ShardingPolicy = REPLICATED) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (the last block's activations [B, S, D], aux loss
    summed over the layers)."""
    b, s = tokens.shape
    x = F.embedding(tokens, params["embed"])
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    remat = policy.remat and torch.is_grad_enabled()
    auxes = []
    for lp in _layers(params):
        if remat:
            x, aux = checkpoint(_block, cfg, policy, x, lp, positions, use_reentrant=False)
        else:
            x, aux = _block(cfg, policy, x, lp, positions)
        auxes.append(aux)
    return x, torch.stack(auxes).sum()


def forward(params: Mapping, tokens: torch.Tensor, cfg: LMConfig,
            policy: ShardingPolicy = REPLICATED) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] float32, aux loss summed over the
    layers)."""
    x, aux = hidden_states(params, tokens, cfg, policy)
    return final_logits(params, x, cfg), aux


# ---------------------------------------------------------------------------
# Decode (serve_step): one token against a KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, s_max: int, dtype=torch.bfloat16,
               device=None) -> dict:
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_shardings(cfg: LMConfig, policy: ShardingPolicy, shard_seq: bool = False) -> dict:
    """JAX's KV-cache specs: batch over the batch axes, kv-heads (or, with
    ``shard_seq``, the sequence) over ``model``.  One batch axis is its
    name, as ``PartitionSpec`` normalises a one-axis tuple."""
    ba, mp = tuple(policy.batch_axes), policy.model_axis
    if len(ba) == 1:
        ba = ba[0]
    s = (None, ba, mp, None, None) if shard_seq else (None, ba, None, mp, None)
    return {"k": s, "v": s}


def decode_step(params: Mapping, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: LMConfig, policy: ShardingPolicy = REPLICATED):
    """tokens [B, 1] + cache @ pos -> (logits [B, V] float32, cache).

    The cache is updated **in place** (row ``pos`` of every layer's keys and
    values) and returned; the cache as it was before the step is gone.  The
    MoE layers use the dense dispatch, with capacity from the B tokens, as
    in the JAX package."""
    x = F.embedding(tokens, params["embed"])       # [B, 1, D]
    for i, lp in enumerate(_layers(params)):
        h = L.apply_norm(cfg.norm, x, _sub(lp, "norm1"))
        h, _, _ = L.decode_attention(_sub(lp, "attn"), h, cache["k"][i], cache["v"][i],
                                     pos, cfg.attn_dims, rope_theta=cfg.rope_theta,
                                     window=cfg.window)
        x = x + h
        h = L.apply_norm(cfg.norm, x, _sub(lp, "norm2"))
        if cfg.is_moe:
            h, _ = M.moe_ffn(_sub(lp, "moe"), h, cfg.moe_dims)
        else:
            h = L.mlp(_sub(lp, "mlp"), h, cfg.mlp)
        x = x + h
    return final_logits(params, x, cfg)[:, 0], cache
