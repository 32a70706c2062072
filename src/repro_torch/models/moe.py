"""Mixture-of-Experts FFN with sort-based static-shape routing (the port of
``repro.models.moe``).

Three dispatch forms, each the JAX package's:

  * :func:`moe_ffn` - dense: every token routed over all experts at once.
  * :func:`moe_ffn_local_tp` - ``local_tp``: experts block-sharded over the
    ``model`` shards of a mesh; each shard routes the data shard's tokens,
    keeps the pairs whose expert it owns, and the partial outputs are summed
    over the shards (the JAX package's psum over ``model``), in shard order.
  * :func:`moe_ffn_monitor` - ``monitor_a2a``, the paper's T3 applied to
    expert tokens: experts partitioned cyclically over the flat ``(group,
    member)`` shards (expert ``e`` on shard ``e % P``), tokens bucketed by
    owner and moved by the two-phase :func:`hierarchical_all_to_all`, the
    outputs returned the same way.

Routing is sort-based with static capacity (tokens over capacity are
dropped, GShard semantics; capacity depends on the batch).  The router is
float32, the aux loss Switch's load-balance term.  Top-k takes the lower
expert index first among equal probabilities, as ``jax.lax.top_k`` does (a
stable descending sort), so ``slot`` and the drops equal the JAX package's
given the same probabilities.  Scatters write unique slots (the drop slot
``E*C`` is thrown away) with ``index_copy``, never float atomics, so the same
inputs give the same bits on the card run to run.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch

from repro_torch.comms.hierarchical import hierarchical_all_to_all
from repro_torch.comms.mesh import VertexComm
from repro_torch.models.layers import F32, gelu, normal, silu


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    d_ff: int          # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    mlp_kind: str = "swiglu"


def init_moe(gen: torch.Generator, dims: MoEDims, *, stack: tuple = (),
             dtype=torch.bfloat16, device=None) -> dict:
    d, f, e = dims.d_model, dims.d_ff, dims.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": normal(gen, stack + (d, e), s_in, F32, device),
         "w_in": normal(gen, stack + (e, d, f), s_in, dtype, device),
         "w_out": normal(gen, stack + (e, f, d), s_out, dtype, device)}
    if dims.mlp_kind == "swiglu":
        p["w_gate"] = normal(gen, stack + (e, d, f), s_in, dtype, device)
    return p


def capacity(tokens: int, dims: MoEDims, buckets: int) -> int:
    """Slots per bucket (an expert, or a device for the monitor dispatch)."""
    return max(1, int(tokens * dims.top_k * dims.capacity_factor / buckets))


def _top_k(probs: torch.Tensor, k: int):
    """(gate [T, k] renormalised, idx [T, k]): the k largest of the router
    probabilities [T, E], the lower index first among equal values."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    gate = torch.gather(probs, 1, idx)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, idx


def _one_hot(ids: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """[len(ids), n] one-hot rows, all zero for an id outside [0, n) (as
    ``jax.nn.one_hot``; ``F.one_hot`` would check the ids on the host)."""
    return (ids[:, None] == torch.arange(n, device=ids.device)).to(dtype)


def _aux(probs: torch.Tensor, idx: torch.Tensor, e: int) -> torch.Tensor:
    """Switch load balance: E * sum(fraction routed top-1 x mean prob)."""
    frac = torch.mean(_one_hot(idx[:, 0], e, F32), dim=0)
    return e * torch.sum(frac * torch.mean(probs, dim=0))


def _slots(bucket: torch.Tensor, n_buckets: int, cap: int) -> torch.Tensor:
    """Sort-based static slots: pair ``i`` of bucket ``b`` (in pair order)
    goes to slot ``b * cap + i`` while ``i < cap``; the rest, and every
    pair with ``bucket == n_buckets`` (not ours), to the drop slot
    ``n_buckets * cap``.  int64 [T*k]."""
    n = bucket.shape[0]
    order = torch.argsort(bucket, stable=True)
    sorted_b = bucket[order]
    start = torch.searchsorted(sorted_b, torch.arange(n_buckets + 1, dtype=bucket.dtype,
                                                      device=bucket.device))
    pos = torch.arange(n, device=bucket.device) - start[sorted_b]
    keep = (sorted_b < n_buckets) & (pos < cap)
    slot_sorted = torch.where(keep, sorted_b * cap + pos, n_buckets * cap)
    return torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)


def _route(logits: torch.Tensor, dims: MoEDims, capacity: int):
    """Sort-based static routing.  logits [T, E] float32.

    Returns (slot [T*k] int64: the target slot in [E*C], or E*C when
    dropped; gate [T*k] float32; aux loss, a float32 scalar).
    """
    e = logits.shape[1]
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, dims.top_k)
    slot = _slots(idx.reshape(-1), e, capacity)
    return slot, gate.reshape(-1), _aux(probs, idx, e)


def _segment_sum(pairs: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """Sum each token's k consecutive pair rows ([T*k, D] -> [T, D]), in
    pair order and in the rows' dtype, as the JAX package's ``segment_sum``
    scatter-adds them."""
    pairs = pairs.reshape(t, k, -1)
    out = pairs[:, 0]
    for j in range(1, k):
        out = out + pairs[:, j]
    return out


def _dispatch(xf: torch.Tensor, slot: torch.Tensor, n_slots: int, k: int) -> torch.Tensor:
    """[n_slots, D]: each kept pair's token row at its slot, zeros elsewhere
    (the drop row ``n_slots`` is cut off)."""
    tok = torch.arange(slot.shape[0], device=xf.device) // k
    buf = xf.new_zeros((n_slots + 1, xf.shape[1])).index_copy(0, slot, xf[tok])
    return buf[:-1]


def _combine(rows: torch.Tensor, slot: torch.Tensor, gate: torch.Tensor, t: int,
             k: int) -> torch.Tensor:
    """[T, D]: each token's gate-weighted sum of its pairs' output rows (a
    dropped pair reads the zero row)."""
    rows = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
    return _segment_sum(rows[slot] * gate[:, None].to(rows.dtype), t, k)


def _expert_mlp(p: Mapping, x: torch.Tensor, dims: MoEDims) -> torch.Tensor:
    """x: [E, C, D] -> [E, C, D] via each expert's FFN (bf16 products with a
    bf16 output, as the JAX package's einsums over the stacked weights)."""
    if dims.mlp_kind == "swiglu":
        h = silu(torch.bmm(x, p["w_gate"])) * torch.bmm(x, p["w_in"])
    else:
        h = gelu(torch.bmm(x, p["w_in"]))
    return torch.bmm(h, p["w_out"]).to(x.dtype)


def moe_ffn(p: Mapping, x: torch.Tensor, dims: MoEDims) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense MoE FFN: x [B, S, D] -> ([B, S, D], aux).  Capacity comes from
    the whole token count."""
    b, s, d = x.shape
    t = b * s
    e, k = dims.n_experts, dims.top_k
    cap = capacity(t, dims, e)
    xf = x.reshape(t, d)
    slot, gate, aux = _route(xf.to(F32) @ p["router"], dims, cap)
    expert_in = _dispatch(xf, slot, e * cap, k).reshape(e, cap, d)
    expert_out = _expert_mlp(p, expert_in, dims).reshape(e * cap, d)
    return _combine(expert_out, slot, gate, t, k).reshape(b, s, d), aux


def moe_ffn_local_tp(p: Mapping, x: torch.Tensor, dims: MoEDims, *,
                     model_shards: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``local_tp`` dispatch of one data shard's tokens x [B_loc, S, D]
    over ``model_shards`` model shards: shard ``me`` holds experts ``[me *
    E/m, (me + 1) * E/m)`` (the weights' block split), routes every local
    token with the replicated router, keeps the pairs whose expert it owns
    (each expert's capacity as in :func:`moe_ffn`) and computes its partial
    output; the partials are summed over the shards in shard order (the JAX
    package's psum over ``model``).  The router and top-k are the same on
    every shard, so they run once."""
    m = model_shards
    b, s, d = x.shape
    t = b * s
    e, k = dims.n_experts, dims.top_k
    if e % m:
        raise ValueError(f"{e} experts do not split over {m} model shards")
    e_loc = e // m
    cap = capacity(t, dims, e)
    xf = x.reshape(t, d)
    probs = torch.softmax(xf.to(F32) @ p["router"], dim=-1)
    gate, idx = _top_k(probs, k)
    flat_e = idx.reshape(-1)
    gate = gate.reshape(-1)
    out = None
    for me in range(m):
        first = me * e_loc
        mine = (flat_e >= first) & (flat_e < first + e_loc)
        slot = _slots(torch.where(mine, flat_e - first, e_loc), e_loc, cap)
        expert_in = _dispatch(xf, slot, e_loc * cap, k).reshape(e_loc, cap, d)
        local_p = {n: w[first:first + e_loc] for n, w in p.items() if n != "router"}
        expert_out = _expert_mlp(local_p, expert_in, dims).reshape(e_loc * cap, d)
        partial = _combine(expert_out, slot, gate, t, k)
        out = partial if out is None else out + partial
    return out.reshape(b, s, d).to(x.dtype), _aux(probs, idx, e)


def _masked_expert_product(rows: torch.Tensor, w: torch.Tensor,
                           onehot: torch.Tensor) -> torch.Tensor:
    """out[t] = rows[t] @ w[e_t] in float32, e_t the expert of row t
    (``einsum("td,edf,te->tf", preferred_element_type=float32)``): each
    local expert's float32 product, masked by its one-hot column and
    summed (adding exact zeros)."""
    rf = rows.to(F32)
    out = None
    for j in range(w.shape[0]):
        term = (rf @ w[j].to(F32)) * onehot[:, j:j + 1]
        out = term if out is None else out + term
    return out


def moe_ffn_monitor(p: Mapping, xs: list, dims: MoEDims, *,
                    comm: VertexComm) -> tuple[list, list]:
    """T3 dispatch over the vertex shards of a ``(group, member)`` mesh:
    ``xs`` holds each local shard's tokens [B_loc, S, D] (``comm.local``
    order), and the result is ``(outs, auxes)``, one per shard.

    Experts are partitioned over the P flat shards cyclically (expert e on
    shard e % P with local index e // P, the heavy-vertex rule of eq. 3), so
    the stacked weights view as [E/P, P, ...] and shard ``me`` takes column
    ``me``.  Each shard routes its tokens with a per-device capacity
    (``cap_dev``), buckets the pairs by owner into [P * cap_dev, D] (with
    each pair's local expert index beside it), and the buckets travel
    through the two-phase :func:`hierarchical_all_to_all`; the owner runs
    its experts on every received row (a one-hot masked product, as the
    JAX package does) and the outputs return through the same
    all-to-all."""
    pdev = comm.n
    e, k = dims.n_experts, dims.top_k
    if e % pdev:
        raise ValueError(f"{e} experts do not split over {pdev} shards")
    e_loc = e // pdev
    b, s, d = xs[0].shape
    t = b * s
    cap = capacity(t, dims, pdev)
    routed, payloads, eidxs = [], [], []
    for x in xs:
        xf = x.reshape(t, d)
        probs = torch.softmax(xf.to(F32) @ p["router"], dim=-1)
        gate, idx = _top_k(probs, k)
        flat_i = idx.reshape(-1)
        slot = _slots(flat_i % pdev, pdev, cap)
        payloads.append(_dispatch(xf, slot, pdev * cap, k))
        eidx = torch.zeros(pdev * cap + 1, dtype=torch.int32, device=x.device) \
            .scatter_reduce(0, slot, (flat_i // pdev).to(torch.int32), "amax")
        eidxs.append(eidx[:-1, None])
        routed.append((slot, gate.reshape(-1), _aux(probs, idx, e)))
    recv = hierarchical_all_to_all(comm, payloads)
    recv_e = hierarchical_all_to_all(comm, eidxs)
    f = p["w_in"].shape[-1]

    def local_w(name, me, trailing):
        return p[name].reshape((e_loc, pdev) + trailing)[:, me]

    ys = []
    for rows, re_, me in zip(recv, recv_e, comm.local):
        onehot = _one_hot(re_[:, 0], e_loc, F32)
        h = _masked_expert_product(rows, local_w("w_in", me, (d, f)), onehot)
        if dims.mlp_kind == "swiglu":
            hg = _masked_expert_product(rows, local_w("w_gate", me, (d, f)), onehot)
            h = silu(hg) * h
        else:
            h = gelu(h)
        y = _masked_expert_product(h.to(rows.dtype), local_w("w_out", me, (f, d)), onehot)
        ys.append(y.to(rows.dtype))
    back = hierarchical_all_to_all(comm, ys)
    outs = [_combine(rows, slot, gate, t, k).reshape(b, s, d)
            for rows, (slot, gate, _) in zip(back, routed)]
    return outs, [aux for _, _, aux in routed]
