"""GNN model zoo in PyTorch: GAT, GraphSAGE, DimeNet, EquiformerV2 (eSCN-style).

The port of ``repro.models.gnn``.  Message passing is built on segment
reductions over edge-index arrays: :func:`segment_sum` is ``index_add``
(atomic on the card, so float sums come in another order from run to run),
:func:`segment_max` is ``scatter_reduce("amax")`` from ``-inf``, as
``jax.ops.segment_max`` leaves an empty segment.  All shapes are static;
padded edges carry the sentinel ``N`` in ``edge_src`` / ``edge_dst`` and
``False`` in ``edge_valid``, and every gathered table (``zs``, ``hs``,
``xs``) keeps one zero row at index ``N`` for them, so no gather leaves its
table.  No module here launches a hand-written kernel: the JAX package's GNN
stack reaches no Pallas kernel, so its products stay ``torch.matmul`` and
its segment reductions ``index_add`` / ``scatter_reduce``.

Parameters are dicts of tensors keyed by the JAX package's pytree paths
(``layers/0/w``, ``blocks/3/w_sbf``, ``layers/1/w_m1_re``); ``*_init`` draws
Glorot-scaled normals on an explicit ``torch.Generator``, with JAX's shapes
(the values cannot be JAX's).  Each ``jax.nn`` activation keeps its op
structure: ``silu`` is ``x * sigmoid(x)``, ``elu`` uses ``expm1``,
``leaky_relu`` is ``where(x >= 0, x, slope * x)``.  Nothing writes in place
into a tensor autograd saved: the SO(2) convolution assembles its m-groups
with ``torch.cat`` and one ``index_select``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.util import resolve_device

Params = dict


@dataclasses.dataclass
class Graph:
    """Static-shape edge-list graph with node features."""

    node_feat: torch.Tensor    # [N, F] float
    edge_src: torch.Tensor     # [E] int32 (sentinel N on padding)
    edge_dst: torch.Tensor     # [E] int32
    edge_valid: torch.Tensor   # [E] bool
    n_nodes: int
    edge_vec: torch.Tensor | None = None   # [E, 3] displacement (molecular)
    graph_ids: torch.Tensor | None = None  # [N] int32 graph id (batched mode)

    def to(self, device) -> "Graph":
        """The same graph with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


# ---------------------------------------------------------------------------
# Segment reductions and the jax.nn activations
# ---------------------------------------------------------------------------

def _long(ix: torch.Tensor) -> torch.Tensor:
    return ix if ix.dtype == torch.int64 else ix.long()


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(x, seg, num_segments=n)``: [E, ...] -> [n, ...]."""
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add(0, _long(seg), x)


def segment_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_max``: an empty segment stays ``-inf``."""
    idx = _long(seg).view((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    init = torch.full((n,) + tuple(x.shape[1:]), -math.inf, dtype=x.dtype,
                      device=x.device)
    return init.scatter_reduce(0, idx, x, "amax", include_self=True)


def _take(table: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, _long(ix))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def elu(x: torch.Tensor) -> torch.Tensor:
    pos = x > 0
    return torch.where(pos, x, torch.expm1(torch.where(pos, torch.zeros_like(x), x)))


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def segment_softmax(scores: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Softmax of ``scores`` [E, H] within each segment of ``seg`` (segments
    ``0..n``; ``n`` is the sentinel).  A segment whose scores are all
    ``-inf`` (or empty) gets max 0 and weights 0."""
    smax = torch.nan_to_num(segment_max(scores, seg, n + 1), nan=0.0, neginf=0.0)
    ex = torch.exp(scores - _take(smax, seg))
    den = segment_sum(ex, seg, n + 1)
    return ex / torch.clamp(_take(den, seg), min=1e-9)


def _glorot(gen: torch.Generator | None, shape: tuple, device) -> torch.Tensor:
    if gen is None:                       # a template: shapes only
        return torch.empty(shape, device=device)
    fan = sum(shape[-2:]) if len(shape) >= 2 else shape[0]
    return torch.randn(shape, generator=gen, device=device) * math.sqrt(2.0 / fan)


def _generator(seed: int, device) -> tuple[torch.Generator | None, torch.device]:
    if device is not None and torch.device(device).type == "meta":
        return None, torch.device("meta")
    device = resolve_device(device)
    return torch.Generator(device=device).manual_seed(seed), device


def _layers(params: Params, name: str = "layers") -> list:
    """The per-layer sub-mappings ``{name}/i/...`` of a path-keyed mapping."""
    out: dict = {}
    for k, v in params.items():
        parts = k.split("/")
        if parts[0] == name:
            out.setdefault(int(parts[1]), {})["/".join(parts[2:])] = v
    return [out[i] for i in range(len(out))]


# ===========================================================================
# GAT  [1710.10903] — SDDMM edge scores -> segment softmax -> SpMM
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    negative_slope: float = 0.2


def _gat_dims(cfg: GATConfig, i: int) -> tuple[int, int, bool]:
    last = i == cfg.n_layers - 1
    return (1 if last else cfg.n_heads), (cfg.n_classes if last else cfg.d_hidden), last


def gat_init(cfg: GATConfig, seed: int = 0, device=None) -> Params:
    gen, device = _generator(seed, device)
    params = {}
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        heads, d_out, _ = _gat_dims(cfg, i)
        params[f"layers/{i}/w"] = _glorot(gen, (d_in, heads * d_out), device)
        params[f"layers/{i}/a_src"] = _glorot(gen, (heads, d_out), device)
        params[f"layers/{i}/a_dst"] = _glorot(gen, (heads, d_out), device)
        d_in = heads * d_out
    return params


def gat_layer(p: Params, g: Graph, h: torch.Tensor, heads: int, d_out: int,
              slope: float, last: bool) -> torch.Tensor:
    n = g.n_nodes
    z = (h @ p["w"]).reshape(-1, heads, d_out)               # [N, H, D]
    zs = torch.cat([z, z.new_zeros((1, heads, d_out))])
    src, dst = g.edge_src, g.edge_dst
    z_src = _take(zs, src)
    e = torch.sum(z_src * p["a_src"], -1) + torch.sum(_take(zs, dst) * p["a_dst"], -1)
    e = leaky_relu(e, slope)                                  # [E, H]
    e = torch.where(g.edge_valid[:, None], e, _f32(-math.inf, e))
    seg = torch.where(g.edge_valid, dst, n)
    alpha = segment_softmax(e, seg, n)                        # [E, H]
    msg = z_src * alpha[:, :, None]
    out = segment_sum(msg, seg, n + 1)[:n]
    out = out.reshape(n, heads * d_out) if not last else out.mean(dim=1)
    return out if last else elu(out)


def gat_forward(params: Params, g: Graph, cfg: GATConfig) -> torch.Tensor:
    h = g.node_feat
    for i, lp in enumerate(_layers(params)):
        heads, d_out, last = _gat_dims(cfg, i)
        h = gat_layer(lp, g, h, heads, d_out, cfg.negative_slope, last)
    return h  # [N, n_classes] logits


# ===========================================================================
# GraphSAGE [1706.02216] — mean aggregator; full-graph + sampled-block modes
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602
    n_classes: int = 41
    sample_sizes: tuple[int, ...] = (25, 10)


def sage_init(cfg: SAGEConfig, seed: int = 0, device=None) -> Params:
    gen, device = _generator(seed, device)
    params = {}
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        d_out = cfg.n_classes if i == cfg.n_layers - 1 else cfg.d_hidden
        params[f"layers/{i}/w_self"] = _glorot(gen, (d_in, d_out), device)
        params[f"layers/{i}/w_neigh"] = _glorot(gen, (d_in, d_out), device)
        d_in = d_out
    return params


def sage_mean(h_src: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              valid: torch.Tensor, n_dst: int) -> torch.Tensor:
    """Mean of the valid edges' source rows per destination row [n_dst, F]
    (0 for a row with no valid edge)."""
    hs = torch.cat([h_src, h_src.new_zeros((1, h_src.shape[1]))])
    seg = torch.where(valid, dst, n_dst)
    msum = segment_sum(_take(hs, torch.where(valid, src, h_src.shape[0])),
                       seg, n_dst + 1)[:n_dst]
    cnt = segment_sum(valid.to(h_src.dtype), seg, n_dst + 1)[:n_dst]
    return msum / torch.clamp(cnt[:, None], min=1.0)


def sage_layer(p: Params, h_src: torch.Tensor, h_dst: torch.Tensor,
               src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
               n_dst: int, last: bool) -> torch.Tensor:
    mean = sage_mean(h_src, src, dst, valid, n_dst)
    out = h_dst @ p["w_self"] + mean @ p["w_neigh"]
    return out if last else torch.relu(out)


def sage_forward(params: Params, g: Graph, cfg: SAGEConfig) -> torch.Tensor:
    """Full-graph mode."""
    h = g.node_feat
    for i, lp in enumerate(_layers(params)):
        h = sage_layer(lp, h, h, g.edge_src, g.edge_dst, g.edge_valid,
                       g.n_nodes, i == cfg.n_layers - 1)
    return h


def sage_forward_blocks(params: Params, feats: torch.Tensor, blocks,
                        cfg: SAGEConfig) -> torch.Tensor:
    """Sampled-minibatch mode (fanout blocks from ``data/sampler.py``).

    ``feats``: [N_hop0, F] features of the outermost sampled frontier;
    ``blocks``: list (outer->inner) of dicts with src/dst/valid/n_dst —
    src indexes the previous layer's rows, dst the next layer's rows.
    """
    h = feats
    for i, (lp, blk) in enumerate(zip(_layers(params), blocks)):
        h = sage_layer(lp, h, h[: blk["n_dst"]], blk["src"], blk["dst"],
                       blk["valid"], blk["n_dst"], i == cfg.n_layers - 1)
    return h


# ===========================================================================
# DimeNet [2003.03123] — RBF/SBF bases + triplet (directional) messages
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 16
    n_targets: int = 1


def _norm(v: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(v, axis=-1)``: the square root of the summed squares."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _bessel_rbf(d: torch.Tensor, n: int, cutoff: float) -> torch.Tensor:
    """Bessel radial basis: sqrt(2/c) * sin(n pi d / c) / d."""
    c = _f32(cutoff, d)
    freq = torch.arange(1, n + 1, dtype=torch.float32, device=d.device) * _f32(math.pi, d)
    dn = torch.clamp(d, min=1e-6)[:, None] / c
    return torch.sqrt(_f32(2.0, d) / c) * torch.sin(freq * dn) / (dn * c)


def _angular_sbf(angle: torch.Tensor, d: torch.Tensor, ns: int, nr: int,
                 cutoff: float) -> torch.Tensor:
    """Simplified spherical basis: Fourier(angle) x Bessel(d), as the JAX
    package's (exact Bessel zeros omitted)."""
    ls = torch.arange(ns, dtype=torch.float32, device=angle.device)
    ang = torch.cos(angle[:, None] * (ls + 1.0))            # [T, ns]
    rad = _bessel_rbf(d, nr, cutoff)                         # [T, nr]
    return (ang[:, :, None] * rad[:, None, :]).reshape(-1, ns * nr)


def dimenet_init(cfg: DimeNetConfig, seed: int = 0, device=None) -> Params:
    gen, device = _generator(seed, device)
    d, nb = cfg.d_hidden, cfg.n_bilinear
    nsr = cfg.n_spherical * cfg.n_radial
    params = {}
    for b in range(cfg.n_blocks):
        for name, shape in (("w_msg", (d, d)), ("w_sbf", (nsr, nb)),
                            ("w_tri_in", (d, nb * d)), ("w_tri_out", (d, d)),
                            ("w_update", (d, d)), ("w_rbf", (cfg.n_radial, d))):
            params[f"blocks/{b}/{name}"] = _glorot(gen, shape, device)
    params["species_emb"] = _glorot(gen, (cfg.n_species, d), device)
    params["w_edge_in"] = _glorot(gen, (2 * d + cfg.n_radial, d), device)
    params["w_out_rbf"] = _glorot(gen, (cfg.n_radial, d), device)
    params["w_out1"] = _glorot(gen, (d, d), device)
    params["w_out2"] = _glorot(gen, (d, cfg.n_targets), device)
    return params


def dimenet_forward(params: Params, g: Graph, species: torch.Tensor,
                    triplets: dict, cfg: DimeNetConfig) -> torch.Tensor:
    """Per-node targets [N, n_targets]. ``triplets``: dict with t_in [T]
    (edge k->j), t_out [T] (edge j->i), angle [T], valid [T]."""
    n, e = g.n_nodes, g.edge_src.shape[0]
    dist = _norm(g.edge_vec)
    rbf = _bessel_rbf(dist, cfg.n_radial, cfg.cutoff)        # [E, nr]
    h = _take(params["species_emb"], species)                 # [N, D]
    hs = torch.cat([h, h.new_zeros((1, cfg.d_hidden))])
    src = torch.where(g.edge_valid, g.edge_src, n)
    dst = torch.where(g.edge_valid, g.edge_dst, n)
    m = silu(torch.cat([_take(hs, src), _take(hs, dst), rbf], dim=-1) @ params["w_edge_in"])

    t_in = torch.clamp(_long(triplets["t_in"]), 0, e - 1)
    t_valid = triplets["valid"]
    sbf = _angular_sbf(triplets["angle"], _take(dist, t_in),
                       cfg.n_spherical, cfg.n_radial, cfg.cutoff)
    sbf = torch.where(t_valid[:, None], sbf, _f32(0.0, sbf))
    seg = torch.where(t_valid, triplets["t_out"], e)

    for bp in _layers(params, "blocks"):
        m2 = silu(m @ bp["w_msg"]) * (rbf @ bp["w_rbf"])
        # directional triplet message: bilinear over the n_bilinear dim
        basis = sbf @ bp["w_sbf"]                             # [T, nb]
        src_m = silu(m2 @ bp["w_tri_in"]).reshape(e, cfg.n_bilinear, cfg.d_hidden)
        tm = torch.einsum("tb,tbd->td", basis, _take(src_m, t_in))
        agg = segment_sum(tm, seg, e + 1)[:e]
        m = m + silu((m2 + agg @ bp["w_tri_out"]) @ bp["w_update"])

    # per-node readout: sum incoming messages weighted by the rbf gate
    gate = rbf @ params["w_out_rbf"]
    node = segment_sum(torch.where(g.edge_valid[:, None], m * gate, _f32(0.0, m)),
                       dst, n + 1)[:n]
    return silu(node @ params["w_out1"]) @ params["w_out2"]   # [N, T]


def dimenet_energy(params: Params, g: Graph, species: torch.Tensor, triplets: dict,
                   cfg: DimeNetConfig, n_graphs: int = 1) -> torch.Tensor:
    per_node = dimenet_forward(params, g, species, triplets, cfg)
    if g.graph_ids is None:
        return torch.sum(per_node, dim=0, keepdim=True)  # [1, n_targets]
    return segment_sum(per_node, g.graph_ids, n_graphs)


# ===========================================================================
# EquiformerV2 [2306.12059] — eSCN-style SO(2) convolutions, l_max=6, m_max=2
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class EquiformerConfig:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_species: int = 16
    n_radial: int = 8
    cutoff: float = 5.0
    n_targets: int = 1

    @property
    def channel_layout(self) -> list[tuple[int, int]]:
        """(l, m) channels with |m| <= min(l, m_max); m<0 as separate rows."""
        out = []
        for l in range(self.l_max + 1):
            for m in range(-min(l, self.m_max), min(l, self.m_max) + 1):
                out.append((l, m))
        return out

    @property
    def n_sph(self) -> int:
        return len(self.channel_layout)   # 29 for l_max=6, m_max=2


def _m_groups(cfg: EquiformerConfig):
    """Indices grouped by |m|: m=0 real block; |m|>0 (cos, sin) pairs."""
    lay = cfg.channel_layout
    g0 = [i for i, (l, m) in enumerate(lay) if m == 0]
    pairs = []
    for mm in range(1, cfg.m_max + 1):
        plus = [i for i, (l, m) in enumerate(lay) if m == mm]
        minus = [i for i, (l, m) in enumerate(lay) if m == -mm]
        pairs.append((minus, plus))
    return g0, pairs


def equiformer_init(cfg: EquiformerConfig, seed: int = 0, device=None) -> Params:
    gen, device = _generator(seed, device)
    d = cfg.d_hidden
    g0, pairs = _m_groups(cfg)
    params = {}
    for i in range(cfg.n_layers):
        pre = f"layers/{i}/"
        params[pre + "w_m0"] = _glorot(gen, (len(g0), d, len(g0), d), device)
        params[pre + "w_radial"] = _glorot(gen, (cfg.n_radial, d), device)
        params[pre + "w_attn"] = _glorot(gen, (d, cfg.n_heads), device)
        params[pre + "w_val"] = _glorot(gen, (d, d), device)
        params[pre + "w_upd"] = _glorot(gen, (d, d), device)
        for gi, (_, plus) in enumerate(pairs):
            k = len(plus)
            params[pre + f"w_m{gi + 1}_re"] = _glorot(gen, (k, d, k, d), device)
            params[pre + f"w_m{gi + 1}_im"] = _glorot(gen, (k, d, k, d), device)
    params["species_emb"] = _glorot(gen, (cfg.n_species, d), device)
    params["w_out1"] = _glorot(gen, (d, d), device)
    params["w_out2"] = _glorot(gen, (d, cfg.n_targets), device)
    return params


def _mix(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("ekd,kdlf->elf", x, w)`` as one [E, k*d] x [k*d, l*f] product."""
    e, k, d = x.shape
    return (x.reshape(e, k * d) @ w.reshape(k * d, -1)).reshape(e, w.shape[2], w.shape[3])


def _so2_conv(lp: Params, x: torch.Tensor, cfg: EquiformerConfig) -> torch.Tensor:
    """Block-diagonal SO(2)-equivariant linear map over (sph, channel).

    x: [E, S, D]. The m=0 block is a free linear map; each |m| block applies
    the (re, im) rotation-commuting pair — eSCN's core trick, O(L^3).  The
    groups partition the S channels, so the output is their concatenation
    put back in channel order."""
    g0, pairs = _m_groups(cfg)
    dev = x.device
    order, parts = list(g0), [_mix(x[:, torch.tensor(g0, device=dev)], lp["w_m0"])]
    for gi, (minus, plus) in enumerate(pairs):
        re, im = lp[f"w_m{gi + 1}_re"], lp[f"w_m{gi + 1}_im"]
        xp = x[:, torch.tensor(plus, device=dev)]            # cos part
        xm = x[:, torch.tensor(minus, device=dev)]           # sin part
        parts.append(_mix(xp, re) - _mix(xm, im))
        parts.append(_mix(xp, im) + _mix(xm, re))
        order += plus + minus
    inverse = [0] * len(order)
    for pos, ch in enumerate(order):
        inverse[ch] = pos
    return torch.cat(parts, dim=1).index_select(1, torch.tensor(inverse, device=dev))


def equiformer_forward(params: Params, g: Graph, species: torch.Tensor,
                       cfg: EquiformerConfig) -> torch.Tensor:
    """Per-node scalar predictions [N, n_targets]."""
    n, d, s = g.n_nodes, cfg.d_hidden, cfg.n_sph
    rbf = _bessel_rbf(_norm(g.edge_vec), cfg.n_radial, cfg.cutoff)   # [E, nr]
    emb = _take(params["species_emb"], species)
    x = torch.cat([emb[:, None, :], emb.new_zeros((n, s - 1, d))], dim=1)  # l=0 init
    pad = x.new_zeros((1, s, d))
    src = torch.where(g.edge_valid, g.edge_src, n)
    seg = torch.where(g.edge_valid, g.edge_dst, n)

    for lp in _layers(params):
        feat = _take(torch.cat([x, pad]), src)                # [E, S, D]
        radial = silu(rbf @ lp["w_radial"])                   # [E, D]
        msg = _so2_conv(lp, feat, cfg) * radial[:, None, :]
        # invariant attention over incoming edges (l=0 channel)
        scores = msg[:, 0] @ lp["w_attn"]                     # [E, H]
        scores = torch.where(g.edge_valid[:, None], scores, _f32(-math.inf, scores))
        alpha = segment_softmax(scores, seg, n)               # [E, H]
        gate = torch.mean(alpha, dim=-1)[:, None, None]
        agg = segment_sum(msg * gate, seg, n + 1)[:n]
        x = x + torch.einsum("nsd,df->nsf", agg, lp["w_upd"])
    inv = x[:, 0]                                             # [N, D] scalars
    return silu(inv @ params["w_out1"]) @ params["w_out2"]


INITS = {"gat-cora": gat_init, "graphsage-reddit": sage_init,
         "dimenet": dimenet_init, "equiformer-v2": equiformer_init}


def param_template(arch: str, cfg) -> Params:
    """Each parameter's shape (float32), keyed by path as ``arch``'s
    ``*_init`` gives them: tensors on the ``meta`` device (no draws)."""
    return INITS[arch](cfg, device="meta")
