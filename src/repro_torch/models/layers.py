"""Model building blocks: norms, RoPE, GQA attention, MLPs (the port of
``repro.models.layers``).

Plain functions over parameter mappings (``{"wq": ..., "wk": ...}``), as
the JAX package's are over its dict pytrees.  Activations are bf16 and
the norms compute in float32.  Where the JAX package asks XLA for float32
products of bf16 operands (``preferred_element_type=jnp.float32``: the
attention scores and values), the port upcasts both operands to float32
and contracts in float32: bf16 products are exact in float32, so only the
order of the float32 sums differs.  A plain ``x @ w`` stays in bf16 with a
bf16 output, as in JAX.  TF32 is never turned on here.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch
from torch.nn import functional as F

F32 = torch.float32
#: the score of a masked position (JAX's ``-1e30``: a row whose every
#: position is masked softmaxes to the uniform average, as in JAX)
MASKED = -1e30


# ---------------------------------------------------------------------------
# Norms. olmo-1b uses *non-parametric* LayerNorm (no scale/bias) [2402.00838].
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * scale.to(F32)
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor | None, bias: torch.Tensor | None,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.to(F32)
    if bias is not None:
        y = y + bias.to(F32)
    return y.to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, p: Mapping) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    if kind == "layernorm":
        return layernorm(x, p["scale"], p.get("bias"))
    if kind == "nonparametric_ln":  # olmo
        return layernorm(x, None, None)
    raise ValueError(kind)


def init_norm(kind: str, d: int, *, stack: tuple = (), dtype=F32, device=None) -> dict:
    """The norm's parameters, each with the leading dims ``stack`` (the
    transformer's stacked layers)."""
    if kind == "rmsnorm":
        return {"scale": torch.ones(stack + (d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(stack + (d,), dtype=dtype, device=device),
                "bias": torch.zeros(stack + (d,), dtype=dtype, device=device)}
    if kind == "nonparametric_ln":
        return {}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE [2104.09864]
# ---------------------------------------------------------------------------

def _f32(value: float, device) -> torch.Tensor:
    """A float32 scalar made on ``device`` by a fill (no host-to-device
    copy, which would wait for the stream on the card)."""
    return torch.full((), value, dtype=F32, device=device)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """``1 / theta ** (arange(0, Dh, 2) / Dh)`` in float32, each division a
    true one (a tensor divisor: on the card ``tensor / python_scalar`` is a
    reciprocal product)."""
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) \
        / _f32(float(head_dim), device)
    return torch.reciprocal(torch.pow(_f32(theta, device), exps))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S].  The head dim splits in
    halves (not interleaved pairs), as in the JAX package."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)          # [Dh/2]
    ang = positions[..., None].to(F32) * freqs               # [..., S, Dh/2]
    cos = torch.cos(ang)[..., None, :]                       # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (batched full-sequence form + single-token decode form)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


def normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """N(0, 1) float32 draws from ``gen`` times ``scale``, cast to ``dtype``
    (JAX's ``(normal(key, shape) * scale).astype(dtype)``)."""
    return (torch.randn(shape, generator=gen, device=device, dtype=F32) * scale).to(dtype)


def init_attention(gen: torch.Generator, dims: AttnDims, *, stack: tuple = (),
                   dtype=torch.bfloat16, device=None) -> dict:
    d, h, hk, dh = dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim
    s = 1.0 / math.sqrt(d)
    return {
        "wq": normal(gen, stack + (d, h * dh), s, dtype, device),
        "wk": normal(gen, stack + (d, hk * dh), s, dtype, device),
        "wv": normal(gen, stack + (d, hk * dh), s, dtype, device),
        "wo": normal(gen, stack + (h * dh, d), s, dtype, device),
    }


def attention(
    p: Mapping,
    x: torch.Tensor,             # [B, S, D]
    dims: AttnDims,
    *,
    positions: torch.Tensor | None = None,
    rope_theta: float = 10000.0,
    causal: bool = True,
    window: int | None = None,   # sliding-window attention (beyond-spec mode)
    q_chunk: int | None = None,  # exact query-chunked attention: caps the
    #   live float32 score block at [B, H, q_chunk, S]
) -> torch.Tensor:
    """Causal GQA self-attention; the grouped form never expands the KV
    heads.  With ``q_chunk`` (dividing S, below it) the queries run in
    chunks, one after another, each against every key: the same result
    with a score block ``S / q_chunk`` times smaller."""
    b, s, _ = x.shape
    h, hk, dh = dims.n_heads, dims.n_kv_heads, dims.head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    positions = positions.expand(b, s)
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (x @ p["wk"]).reshape(b, s, hk, dh)
    v = (x @ p["wv"]).reshape(b, s, hk, dh)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    g = dims.q_per_kv
    qg = q.reshape(b, s, hk, g, dh)
    kf, vf = k.to(F32), v.to(F32)
    scale = _f32(math.sqrt(dh), x.device)

    def block(qg_c, pos_c):
        """qg_c [B, qc, HK, G, Dh]; pos_c [B, qc] -> out [B, qc, H*Dh]."""
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg_c.to(F32), kf) / scale
        if causal:
            mask = pos_c[:, :, None] >= positions[:, None, :]    # [B, qc, Sk]
            if window is not None:
                mask = mask & (pos_c[:, :, None] - positions[:, None, :] < window)
            scores = torch.where(mask[:, None, None], scores, MASKED)
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", w.to(x.dtype).to(F32), vf)
        return out.reshape(qg_c.shape[0], qg_c.shape[1], h * dh).to(x.dtype)

    if q_chunk is None or s <= q_chunk or s % q_chunk:
        out = block(qg, positions)
    else:
        out = torch.cat([block(qg[:, i:i + q_chunk], positions[:, i:i + q_chunk])
                         for i in range(0, s, q_chunk)], dim=1)
    return out @ p["wo"]


def decode_attention(
    p: Mapping,
    x: torch.Tensor,             # [B, 1, D] - one new token
    cache_k: torch.Tensor,       # [B, S_max, HK, Dh]
    cache_v: torch.Tensor,
    pos: int,                    # the new token's position
    dims: AttnDims,
    *,
    rope_theta: float = 10000.0,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-step KV-cache attention; returns ``(out, cache_k, cache_v)``.

    Unlike the JAX package, which returns new caches, the new key and value
    are written **in place** into row ``pos`` of ``cache_k`` / ``cache_v``,
    and the same tensors are returned: a caller must not reuse the caches
    as they were before the step.  Attention covers all ``S_max`` rows under
    a mask, so a step costs the same at every ``pos``."""
    b = x.shape[0]
    h, hk, dh = dims.n_heads, dims.n_kv_heads, dims.head_dim
    s_max = cache_k.shape[1]
    q = (x @ p["wq"]).reshape(b, 1, h, dh)
    k_new = (x @ p["wk"]).reshape(b, 1, hk, dh)
    v_new = (x @ p["wv"]).reshape(b, 1, hk, dh)
    posb = torch.full((b, 1), pos, device=x.device)
    q = apply_rope(q, posb, rope_theta)
    k_new = apply_rope(k_new, posb, rope_theta)
    cache_k[:, pos:pos + 1] = k_new
    cache_v[:, pos:pos + 1] = v_new
    qg = q.reshape(b, hk, dims.q_per_kv, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(F32), cache_k.to(F32)) \
        / _f32(math.sqrt(dh), x.device)
    span = torch.arange(s_max, device=x.device)
    valid = span <= pos
    if window is not None:
        valid = valid & (span > pos - window)
    scores = torch.where(valid[None, None, None, :], scores, MASKED)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(x.dtype).to(F32), cache_v.to(F32))
    out = out.reshape(b, 1, h * dh).to(x.dtype)
    return out @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# MLPs: plain GELU (starcoder2) and gated SwiGLU (llama-likes)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, kind: str, *, stack: tuple = (),
             dtype=torch.bfloat16, device=None) -> dict:
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    p = {"w_in": normal(gen, stack + (d, d_ff), s_in, dtype, device),
         "w_out": normal(gen, stack + (d_ff, d), s_out, dtype, device)}
    if kind == "swiglu":
        p["w_gate"] = normal(gen, stack + (d, d_ff), s_in, dtype, device)
    return p


# XLA on the CPU computes a bf16 activation as a chain of bf16 operations,
# each rounded: the sigmoid is ``1 / (1 + exp(-x))`` (``logistic_impl``) and
# ``jax.nn.gelu`` its tanh formula with bf16 constants.  torch rounds the
# exact sigmoid or gelu once, which differs from XLA's last bit on many
# inputs and flips MoE routes.  So the bf16 activations below are XLA's
# chains, and their backward is JAX's jvp rules transposed, also rounded at
# each step (autograd through the chain rounds other intermediates).
# float32 inputs keep torch's ``sigmoid`` / ``gelu``, which are closer to
# XLA's float32 bits than the chain is.

#: ``sqrt(2 / pi)`` and ``0.044715`` rounded to bf16, as ``jax.nn.gelu``
#: rounds them to a bf16 input's dtype
_GELU_C = 0.796875
_GELU_A = 0.044677734375


class _SiluBF16(torch.autograd.Function):
    """``x * (1 / (1 + exp(-x)))``; the backward is ``g*s + (g*x)*(s*(1-s))``
    (the product rule and ``logistic``'s jvp, ``g * (ans * (1 - ans))``)."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


class _GeluBF16(torch.autograd.Function):
    """``x * (0.5 * (1 + tanh(c * (x + a * ((x * x) * x)))))``; the backward
    transposes the product, ``tanh``'s jvp ``(g + g*ans) * (1 - ans)`` and
    ``integer_pow``'s ``g * (3 * x**2)``, in JAX's order."""

    @staticmethod
    def forward(ctx, x):
        t = torch.tanh(_GELU_C * (x + _GELU_A * ((x * x) * x)))
        cdf = 0.5 * (1 + t)
        ctx.save_for_backward(x, t, cdf)
        return x * cdf

    @staticmethod
    def backward(ctx, g):
        x, t, cdf = ctx.saved_tensors
        c1 = ((g * x) * 0.5) * (1 - t)
        ct_in = (c1 + c1 * t) * _GELU_C
        return ((g * cdf) + ct_in) + ((ct_in * _GELU_A) * (3 * (x * x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    if x.dtype == torch.bfloat16:
        return _GeluBF16.apply(x)
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)`` (``F.silu`` rounds a bf16 input
    once, which moves a SwiGLU output by several ulps after the down
    projection)."""
    if x.dtype == torch.bfloat16:
        return _SiluBF16.apply(x)
    return x * torch.sigmoid(x)


def mlp(p: Mapping, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        h = gelu(x @ p["w_in"])
    elif kind == "swiglu":
        h = silu(x @ p["w_gate"]) * (x @ p["w_in"])
    else:
        raise ValueError(kind)
    return h @ p["w_out"]
