"""Per-(arch x shape) dry-run cells: the step, its ``meta`` inputs, their
shardings and the analytic MODEL_FLOPS (the port of
``repro.launch.input_specs``).

Everything here is shape-only: every input is a tensor on the ``meta``
device (the counterpart of JAX's ``ShapeDtypeStruct``), so building a cell
allocates nothing and reads no value.  The shardings are per-leaf
:class:`Spec` tuples (one entry per dimension: ``None``, a mesh axis or a
tuple of axes, as a ``PartitionSpec``) in the structure of the inputs,
dicts keyed by path as ``transformer.param_shardings`` gives them;
:func:`shard_shape` is ``NamedSharding.shard_shape``.

Each step runs the port's own code at the cell's **global** shapes on one
(meta) device; ``CellPlan.compute_shards`` is the number of chips the cell
splits that work over, by which the dry run divides its counts.  The
vertex-sharded steps (graph500, the owner-partitioned SAGE variants, the
MoE dispatch variants) run every shard of a virtual mesh, whose collectives
the census records (``launch.collective_census``); ``CellPlan.modeled``
enters the collectives the JAX cell's shardings imply but the one-card code
never runs.

Differences from the JAX package's cells, by design:

  * no ``unroll_layers`` and no 1- / 2-layer probes: XLA's cost analysis
    counts a while-loop body once, a dispatch-level counter counts every
    layer;
  * the LM decode step takes an int position: it decodes at the cell's
    last cache row (the port's decode attention masks the whole cache, so
    every position costs the same);
  * graph500's step is one level body of the vertex-sharded engine over
    every shard (the owned-edge relax of every chunk, the exchange, the
    psums and the frontier update; no heavy core), not the traversal;
  * the ``owner_gather`` variants run JAX's padded per-shard edge blocks
    (the port's run drops each shard's padding).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.comms.mesh import Mesh, make_mesh
from repro_torch.configs import get
from repro_torch.configs.lm_archs import padded_vocab
from repro_torch.data.sampler import static_block_specs
from repro_torch.models import gnn, recsys, transformer as T
from repro_torch.models.gnn import Graph
from repro_torch.optim.optimizer import AdamW, AdamWState, cosine
from repro_torch.train import train_step as TS


class Spec(tuple):
    """A partition spec: per dimension None, a mesh axis, or a tuple of axes
    (dims past its length are unsharded)."""


REP = Spec(())


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: str
    step: Callable
    args: tuple              # meta tensors (trees)
    in_shardings: Any        # Spec trees in the structure of ``args``
    out_shardings: Any       # Spec trees in the structure of the outputs
    model_flops_global: float
    skip_reason: str | None = None
    supplementary: bool = False
    note: str = ""
    compute_shards: int = 1  # chips the step's work splits over
    modeled: Callable | None = None   # modeled(census): the implied collectives


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _axes(mesh: Mesh):
    multi = "pod" in mesh.axis_names
    batch_axes = ("pod", "data") if multi else ("data",)
    return multi, batch_axes


def _size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.size(a) for a in axes)


def shard_shape(global_shape, spec, mesh: Mesh) -> tuple:
    """One shard's shape of an array of ``global_shape`` laid out by
    ``spec`` on ``mesh`` (``NamedSharding.shard_shape``); a dimension the
    axes do not divide is a ``ValueError``."""
    out = []
    for i, dim in enumerate(global_shape):
        n = _size(mesh, spec[i]) if i < len(spec) else 1
        if dim % n:
            raise ValueError(f"dimension {i} of {tuple(global_shape)} does not "
                             f"split over {spec[i]!r} ({n} shards)")
        out.append(dim // n)
    return tuple(out)


def flatten(tree, prefix: str = "") -> list:
    """``(path, leaf)`` of a tree of dicts, tuples, lists, NamedTuples and
    dataclasses, leaves being tensors or :class:`Spec` (None fields and
    non-tensor fields of a dataclass are skipped; a dict's path keys are
    joined with ``/``, as the JAX package's tree paths)."""
    join = (lambda k: f"{prefix}/{k}" if prefix else str(k))
    if isinstance(tree, (torch.Tensor, Spec)):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in flatten(v, join(k))]
    if hasattr(tree, "_fields"):
        return [kv for k in tree._fields for kv in flatten(getattr(tree, k), join(k))]
    if dataclasses.is_dataclass(tree):
        return [kv for f in dataclasses.fields(tree)
                if isinstance(getattr(tree, f.name), torch.Tensor)
                for kv in flatten(getattr(tree, f.name), join(f.name))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree) for kv in flatten(v, join(i))]
    if tree is None or isinstance(tree, (int, float)):
        return []
    raise TypeError(f"cannot flatten {type(tree).__name__} at {prefix!r}")


def leaf_layout(tree, shardings, mesh: Mesh) -> dict:
    """path -> (shape, dtype name, shard shape) of every tensor leaf of
    ``tree`` under ``shardings`` (the same paths)."""
    specs = dict(flatten(shardings))
    out = {}
    for path, t in flatten(tree):
        if path not in specs:
            raise KeyError(f"no sharding for leaf {path!r}")
        out[path] = (tuple(t.shape), str(t.dtype).removeprefix("torch."),
                     shard_shape(t.shape, specs[path], mesh))
    return out


def _specs_like(tree: dict, spec: Spec) -> dict:
    return {k: spec for k in tree}


# ---------------------------------------------------------------------------
# Modelled collectives (rules: launch.collective_census)
# ---------------------------------------------------------------------------

def _grad_sync(census, params: dict, pshard: dict, mesh: Mesh, data_axes,
               zero1: bool = False) -> None:
    """Data-parallel gradients: an all-reduce of every gradient shard over
    the data axes, or under ZeRO-1 a reduce-scatter plus an all-gather of
    the updated shard."""
    d = _size(mesh, data_axes)
    for k, p in params.items():
        b = math.prod(shard_shape(p.shape, pshard[k], mesh)) * p.element_size()
        if zero1:
            census.model("reduce-scatter", b / d, d, "zero1 gradient reduce-scatter")
            census.model("all-gather", b, d, "zero1 parameter all-gather")
        else:
            census.model("all-reduce", b, d, "data-parallel gradient all-reduce")


def _tp_activations(census, n: int, act_bytes: float, mesh: Mesh, seq: bool,
                    what: str) -> None:
    """``n`` Megatron TP all-reduces of ``act_bytes`` over ``model`` (under
    sequence sharding each a reduce-scatter plus an all-gather)."""
    m = mesh.size("model")
    if seq:
        census.model("reduce-scatter", act_bytes / m, m, what, times=n)
        census.model("all-gather", act_bytes, m, what, times=n)
    else:
        census.model("all-reduce", act_bytes, m, what, times=n)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_policy(mesh: Mesh, *, remat=True, variant="baseline"):
    _, ba = _axes(mesh)
    moe_mode = "dense"
    if variant.startswith("local_tp"):
        moe_mode = "local_tp"
    elif variant.startswith("monitor_a2a"):
        moe_mode = "monitor_a2a"
    seq = variant in ("seq_sharded", "local_tp_sp", "qchunk_sp", "seq_sharded_zero1")
    q_chunk = 1024 if variant in ("qchunk", "qchunk_sp") else None
    return T.ShardingPolicy(mesh=mesh, batch_axes=ba, model_axis="model",
                            remat=remat, sequence_sharded=seq,
                            moe_mode=moe_mode, q_chunk=q_chunk)


def _run_policy(policy: T.ShardingPolicy) -> T.ShardingPolicy:
    """The policy the step runs under: the T3 ``monitor_a2a`` dispatch runs
    on a ``(group, member)`` mesh of the two batch axes (``pod``, ``data``),
    as the JAX package's ``shard_map`` does; with one batch axis the
    dispatch refuses, as JAX's does."""
    ba = policy.batch_axes
    if policy.moe_mode != "monitor_a2a" or len(ba) < 2:
        return policy
    mesh = policy.mesh
    gm = make_mesh((mesh.size(ba[0]), mesh.size(ba[-1])), ("group", "member"),
                   device=mesh.devices[0], virtual=True)
    return dataclasses.replace(policy, mesh=gm, batch_axes=("group", "member"),
                               model_axis=None)


def _zero1_shardings(mesh: Mesh, pshard: dict, params: dict, data_axes) -> dict:
    """ZeRO-1: additionally shard optimizer moments over the data axes — the
    first unsharded dim divisible by the DP size takes them."""
    dsz = math.prod(mesh.size(a) for a in data_axes)
    tag = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    out = {}
    for k, spec in pshard.items():
        shape = params[k].shape
        spec = list(spec) + [None] * (len(shape) - len(spec))
        for i, dim in enumerate(shape):
            if spec[i] is None and dim % dsz == 0 and dim > 0:
                spec[i] = tag
                break
        else:
            out[k] = pshard[k]
            continue
        out[k] = Spec(spec)
    return out


def _lm_param_state(cfg, mesh, policy, with_opt: bool, zero1: bool = False):
    params = T.param_template(cfg)
    pshard = {k: Spec(v) for k, v in T.param_shardings(cfg, policy).items()}
    if not with_opt:
        return params, pshard, None, None
    opt = AdamW(cosine(3e-4, 100, 10000))
    opt_state = opt.init(params)
    mv = pshard
    if zero1:
        _, ba = _axes(mesh)
        mv = _zero1_shardings(mesh, pshard, params, ba)
    return params, pshard, (opt, opt_state), AdamWState(REP, mv, dict(mv))


def lm_cell(arch: str, shape: str, mesh: Mesh, variant: str = "baseline") -> CellPlan:
    spec = get(arch)
    cfg = padded_vocab(spec.make_config())
    cell = spec.shape(shape)
    s, gb = cell.dims["seq_len"], cell.dims["global_batch"]
    _, ba = _axes(mesh)
    nd = math.prod(mesh.shape)
    d_data = _size(mesh, ba)

    if cell.kind == "train":
        policy = _lm_policy(mesh, variant=variant)
        zero1 = "zero1" in variant
        params, pshard, (opt, opt_state), oshard = _lm_param_state(
            cfg, mesh, policy, with_opt=True, zero1=zero1)
        step = TS.make_lm_train_step(cfg, opt, _run_policy(policy))
        batch = {"tokens": _meta((gb, s), torch.int32),
                 "labels": _meta((gb, s), torch.int32)}
        bshard = {"tokens": Spec((ba, None)), "labels": Spec((ba, None))}
        flops = 6.0 * cfg.active_param_count() * gb * s
        act = gb // d_data * s * cfg.d_model * 2
        ffn_ar = 0 if policy.moe_mode == "monitor_a2a" else 1

        def modeled(census):
            per_pass = cfg.n_layers * (1 + ffn_ar)
            _tp_activations(census, 3 * per_pass + 2, act, mesh, policy.sequence_sharded,
                            "Megatron TP activation all-reduce (forward, backward, remat)")
            _grad_sync(census, params, pshard, mesh, ba, zero1)

        return CellPlan(arch, shape, step, (params, opt_state, batch),
                        (pshard, oshard, bshard), (pshard, oshard, REP), flops,
                        compute_shards=nd, modeled=modeled)

    if cell.kind == "prefill":
        policy = _lm_policy(mesh, remat=False, variant=variant)
        params, pshard, _, _ = _lm_param_state(cfg, mesh, policy, False)
        step = TS.make_lm_prefill(cfg, _run_policy(policy))
        tokens = _meta((gb, s), torch.int32)
        tshard = Spec((ba, None))
        flops = 2.0 * cfg.active_param_count() * gb * s
        act = gb // d_data * s * cfg.d_model * 2
        ffn_ar = 0 if policy.moe_mode == "monitor_a2a" else 1

        def modeled(census):
            _tp_activations(census, cfg.n_layers * (1 + ffn_ar) + 1, act, mesh,
                            policy.sequence_sharded, "Megatron TP activation all-reduce")

        return CellPlan(arch, shape, step, (params, tokens), (pshard, tshard),
                        Spec((ba, None)), flops, compute_shards=nd, modeled=modeled)

    # decode cells
    skip = None
    supplementary = False
    note = ""
    wcfg = cfg
    if shape == "long_500k":
        # pure full-attention archs: official cell skipped; run the
        # beyond-spec sliding-window mode as a supplementary row.
        skip = "SKIP(full-attn)"
        wcfg = dataclasses.replace(cfg, window=8192)
        supplementary = True
        note = "supplementary sliding-window (8k) row; official cell skipped"
    policy = _lm_policy(mesh, remat=False)
    params, pshard, _, _ = _lm_param_state(wcfg, mesh, policy, False)
    serve = TS.make_lm_serve_step(wcfg, policy)
    shard_seq = (gb == 1) or (wcfg.n_kv_heads % 16 != 0)
    cache = T.init_cache(wcfg, gb, s, device="meta")
    cspec = Spec(T.cache_shardings(wcfg, policy, shard_seq=shard_seq)["k"])
    seq_group = mesh.size("model")
    if gb == 1:
        # batch unshardable: KV sequence shards over every non-model axis too
        cspec = Spec((None, None, tuple(ba) + ("model",), None, None))
        seq_group = nd
    cshard = {"k": cspec, "v": cspec}
    tokens = _meta((gb, 1), torch.int32)
    tshard = Spec((ba if gb > 1 else None, None))
    pos = _meta((), torch.int32)
    flops = 2.0 * wcfg.active_param_count() * gb
    b_loc = gb // d_data if gb > 1 else 1

    def step(params, cache, tokens, pos):
        return serve(params, cache, tokens, s - 1)

    def modeled(census):
        _tp_activations(census, 2 * wcfg.n_layers + 1, b_loc * wcfg.d_model * 2, mesh,
                        False, "Megatron TP activation all-reduce")
        if shard_seq:
            h = wcfg.n_heads
            for nbytes in (b_loc * h * wcfg.head_dim * 4, b_loc * h * 4, b_loc * h * 4):
                census.model("all-reduce", nbytes, seq_group,
                             "sequence-sharded decode attention partials",
                             times=wcfg.n_layers)

    return CellPlan(arch, shape, step, (params, cache, tokens, pos),
                    (pshard, cshard, tshard, REP), (tshard, cshard), flops,
                    skip_reason=skip, supplementary=supplementary, note=note,
                    compute_shards=nd, modeled=modeled)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _graph_meta(n: int, e: int, d: int, with_vec: bool, n_devices: int):
    n = _pad_to(n, n_devices)
    e = _pad_to(e, n_devices)
    return Graph(
        node_feat=_meta((n, d), torch.float32),
        edge_src=_meta((e,), torch.int32),
        edge_dst=_meta((e,), torch.int32),
        edge_valid=_meta((e,), torch.bool),
        n_nodes=n,
        edge_vec=_meta((e, 3), torch.float32) if with_vec else None,
        graph_ids=None,
    ), n, e


def _gnn_opt_state(params: dict):
    opt = AdamW(cosine(1e-3, 10, 1000))
    return opt, opt.init(params)


def _rep_state(params: dict) -> AdamWState:
    return AdamWState(REP, _specs_like(params, REP), _specs_like(params, REP))


def _gnn_grad_model(params: dict, mesh: Mesh, axes):
    def modeled(census):
        _grad_sync(census, params, _specs_like(params, REP), mesh, axes)
    return modeled


def gnn_cell(arch: str, shape: str, mesh: Mesh, variant: str = "baseline") -> CellPlan:
    spec = get(arch)
    cell = spec.shape(shape)
    _, ba = _axes(mesh)
    nd = math.prod(mesh.shape)
    all_axes = tuple(mesh.axis_names)
    shard0 = Spec((all_axes,))
    geo = arch in ("dimenet", "equiformer-v2")

    if cell.kind == "minibatch":
        # sampled-fanout training, data-parallel over (pod, data); the model
        # axis idles, as in the JAX package's baseline.
        dp = _size(mesh, ba)
        seeds = max(1, cell.dims["batch_nodes"] // dp)
        fanout = cell.dims["fanout"]
        d_feat = cell.dims["d_feat"]
        blocks_spec, total_nodes = static_block_specs(seeds, fanout)
        if arch == "graphsage-reddit":
            cfg = dataclasses.replace(spec.make_config(), d_in=d_feat,
                                      n_classes=41, sample_sizes=fanout)
        elif arch == "gat-cora":
            cfg = dataclasses.replace(spec.make_config(), d_in=d_feat, n_classes=41)
        else:
            cfg = spec.make_config()
        # stacked per-replica blocks; dim0 sharded over (pod, data).  n_dst
        # is static, closed over.
        n_dsts = [b["n_dst"] for b in blocks_spec]
        feats = _meta((dp, total_nodes, d_feat), torch.float32)
        labels = _meta((dp, seeds), torch.int32)
        blocks = [{"src": _meta((dp, b["n_edges"]), torch.int32),
                   "dst": _meta((dp, b["n_edges"]), torch.int32),
                   "valid": _meta((dp, b["n_edges"]), torch.bool)}
                  for b in blocks_spec]
        params = gnn.param_template(arch, cfg)
        opt, opt_state = _gnn_opt_state(params)
        if arch == "graphsage-reddit":
            def base_loss(p, f, bl, y):
                logits = gnn.sage_forward_blocks(p, f, bl, cfg)
                return TS.softmax_xent(logits.to(torch.float32), y)
        else:
            def base_loss(p, f, bl, y):
                return _generic_block_loss(arch, cfg, p, f, bl, y)

        def mean_loss(p, feats, blocks, labels):
            losses = [base_loss(p, feats[r],
                                [dict(src=b["src"][r], dst=b["dst"][r],
                                      valid=b["valid"][r], n_dst=n)
                                 for b, n in zip(blocks, n_dsts)], labels[r])
                      for r in range(dp)]
            return torch.stack(losses).mean()

        step = TS._train_step(mean_loss, opt)
        dshard = Spec((ba,))
        in_sh = (_specs_like(params, REP), _rep_state(params), dshard,
                 [dict(src=dshard, dst=dshard, valid=dshard) for _ in blocks_spec],
                 dshard)
        flops = _gnn_flops(arch, cfg, total_nodes * dp,
                           sum(b["n_edges"] for b in blocks_spec) * dp, d_feat) * 3.0
        return CellPlan(arch, shape, step, (params, opt_state, feats, blocks, labels),
                        in_sh, (_specs_like(params, REP), _rep_state(params), REP),
                        flops, compute_shards=dp,
                        modeled=_gnn_grad_model(params, mesh, ba))

    if cell.kind == "batched_small":
        n = cell.dims["n_nodes"] * cell.dims["batch"]
        e = cell.dims["n_edges"] * cell.dims["batch"]
        d_feat = 16
        nb = cell.dims["batch"]
    else:
        n, e = cell.dims["n_nodes"], cell.dims["n_edges"]
        d_feat = cell.dims["d_feat"]
        nb = 1

    # owner-partitioned SAGE with the monitor gather
    if variant.startswith("owner_gather") and arch == "graphsage-reddit" \
            and cell.kind == "full_graph":
        from repro_torch.models.gnn_dist import make_sage_dist_step

        n_pad, e_pad = _pad_to(n, nd), _pad_to(e, nd)
        cfg = dataclasses.replace(spec.make_config(), d_in=d_feat, n_classes=47)
        params = gnn.param_template(arch, cfg)
        opt, opt_state = _gnn_opt_state(params)
        gather_dtype = torch.bfloat16 if variant.endswith("bf16") else torch.float32
        m = mesh.shape[-1]
        gm = make_mesh((nd // m, m), ("group", "member"), device=mesh.devices[0],
                       virtual=True)
        step = make_sage_dist_step(cfg, opt, gm, n_pad,
                                   hierarchical=not variant.endswith("flat"),
                                   gather_dtype=gather_dtype, keep_padding=True)
        args = (params, opt_state, _meta((n_pad, d_feat), torch.float32),
                _meta((e_pad,), torch.int32), _meta((e_pad,), torch.int32),
                _meta((e_pad,), torch.bool), _meta((n_pad,), torch.int32))
        in_sh = (_specs_like(params, REP), _rep_state(params), Spec((all_axes, None)),
                 shard0, shard0, shard0, shard0)
        flops = _gnn_flops(arch, cfg, n_pad, e_pad, d_feat) * 3.0
        return CellPlan(arch, shape, step, args, in_sh,
                        (_specs_like(params, REP), _rep_state(params), REP),
                        flops, note=f"variant={variant}", compute_shards=nd)

    g, n_pad, e_pad = _graph_meta(n, e, d_feat, geo, nd)
    if cell.kind == "batched_small":
        g = dataclasses.replace(g, graph_ids=_meta((n_pad,), torch.int32))
    gshard = {"node_feat": Spec((all_axes, None)), "edge_src": shard0,
              "edge_dst": shard0, "edge_valid": shard0}
    if geo:
        gshard["edge_vec"] = Spec((all_axes, None))
    if cell.kind == "batched_small":
        gshard["graph_ids"] = shard0

    if arch == "gat-cora":
        cfg = dataclasses.replace(spec.make_config(), d_in=d_feat, n_classes=max(7, 8))
        params = gnn.param_template(arch, cfg)
        opt, opt_state = _gnn_opt_state(params)
        step = TS.make_gnn_train_step("gat", cfg, opt)
        args = (params, opt_state, g, _meta((n_pad,), torch.int32))
        rest_sh = (gshard, shard0)
    elif arch == "graphsage-reddit":
        cfg = dataclasses.replace(spec.make_config(), d_in=d_feat, n_classes=47)
        params = gnn.param_template(arch, cfg)
        opt, opt_state = _gnn_opt_state(params)
        step = TS.make_gnn_train_step("sage", cfg, opt)
        args = (params, opt_state, g, _meta((n_pad,), torch.int32))
        rest_sh = (gshard, shard0)
    elif arch == "dimenet":
        cfg = spec.make_config()
        params = gnn.param_template(arch, cfg)
        opt, opt_state = _gnn_opt_state(params)
        t_cap = _pad_to(min(8 * e_pad, 1 << 28), nd)
        triplets = {"t_in": _meta((t_cap,), torch.int32),
                    "t_out": _meta((t_cap,), torch.int32),
                    "angle": _meta((t_cap,), torch.float32),
                    "valid": _meta((t_cap,), torch.bool)}
        step = TS.make_dimenet_train_step(cfg, opt, n_graphs=nb)
        args = (params, opt_state, g, _meta((n_pad,), torch.int32), triplets,
                _meta((nb,), torch.float32))
        rest_sh = (gshard, shard0, _specs_like(triplets, shard0), REP)
    else:  # equiformer-v2
        cfg = spec.make_config()
        params = gnn.param_template(arch, cfg)
        opt, opt_state = _gnn_opt_state(params)
        step = TS.make_equiformer_train_step(cfg, opt)
        args = (params, opt_state, g, _meta((n_pad,), torch.int32),
                _meta((n_pad,), torch.float32))
        rest_sh = (gshard, shard0, shard0)

    flops = _gnn_flops(arch, cfg, n_pad, e_pad, d_feat) * 3.0  # fwd+bwd
    psh = (_specs_like(params, REP), _rep_state(params))
    return CellPlan(arch, shape, step, args, psh + rest_sh, psh + (REP,), flops,
                    compute_shards=nd, modeled=_gnn_grad_model(params, mesh, all_axes))


def _generic_block_loss(arch, cfg, params, feats, blocks, labels):
    """GAT and the geometric archs on sampled blocks: their own layers over
    the innermost block, treated as a graph (the JAX package's cell)."""
    n = feats.shape[0]
    b0 = blocks[0]
    if arch == "gat-cora":
        g = Graph(node_feat=feats, edge_src=b0["src"], edge_dst=b0["dst"],
                  edge_valid=b0["valid"], n_nodes=n)
        logits = gnn.gat_forward(params, g, cfg)
        k = labels.shape[0]
        return TS.softmax_xent(logits[:k].to(torch.float32), labels)
    e = b0["src"].shape[0]
    dev = feats.device
    g = Graph(node_feat=feats, edge_src=b0["src"], edge_dst=b0["dst"],
              edge_valid=b0["valid"], n_nodes=n,
              edge_vec=torch.ones((e, 3), dtype=torch.float32, device=dev))
    species = torch.zeros((n,), dtype=torch.int32, device=dev)
    if arch == "dimenet":
        triplets = {"t_in": torch.zeros((e,), dtype=torch.int32, device=dev),
                    "t_out": torch.zeros((e,), dtype=torch.int32, device=dev),
                    "angle": torch.zeros((e,), dtype=torch.float32, device=dev),
                    "valid": torch.zeros((e,), dtype=torch.bool, device=dev)}
        en = gnn.dimenet_energy(params, g, species, triplets, cfg, 1)
        return torch.mean(torch.square(en))
    out = gnn.equiformer_forward(params, g, species, cfg)
    return torch.mean(torch.square(out))


def _gnn_flops(arch, cfg, n, e, d_feat) -> float:
    """Analytic forward FLOPs (caller multiplies x3 for fwd+bwd)."""
    if arch == "gat-cora":
        d = cfg.d_hidden * cfg.n_heads
        return 2.0 * n * d_feat * d + 6.0 * e * d
    if arch == "graphsage-reddit":
        d = cfg.d_hidden
        return cfg.n_layers * (4.0 * n * d_feat * d + 2.0 * e * d)
    if arch == "dimenet":
        d, nb = cfg.d_hidden, cfg.n_bilinear
        t = 8 * e
        return cfg.n_blocks * (2.0 * e * d * d * (2 + nb) + 2.0 * t * nb * d)
    # equiformer-v2
    d, s = cfg.d_hidden, cfg.n_sph
    per_edge = 2.0 * s * d * s * d / max(cfg.m_max * 2 + 1, 1)  # block-diag
    return cfg.n_layers * (per_edge * e + 2.0 * n * d * d)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def recsys_cell(arch: str, shape: str, mesh: Mesh, variant: str = "baseline") -> CellPlan:
    spec = get(arch)
    cfg = spec.make_config()
    cell = spec.shape(shape)
    _, ba = _axes(mesh)
    all_axes = tuple(mesh.axis_names)
    nd = math.prod(mesh.shape)
    dp = _size(mesh, ba)
    params = recsys.param_template(cfg)
    # tables row-sharded over model (row-cyclic by construction of ids)
    pshard = _specs_like(params, REP)
    pshard["table"] = Spec(("model", None))
    pshard["linear"] = Spec(("model",))
    f, d = cfg.n_sparse, cfg.embed_dim

    def lookups(census, b_loc, times):
        # row-sharded tables: the looked-up rows and linear terms all-reduced
        # over model
        m = mesh.size("model")
        for nbytes in (b_loc * f * d * 4, b_loc * f * 4):
            census.model("all-reduce", nbytes, m, "row-sharded table lookup all-reduce",
                         times=times)

    if cell.kind == "train":
        b = cell.dims["batch"]
        opt = AdamW(cosine(1e-3, 100, 10000))
        opt_state = opt.init(params)
        oshard = AdamWState(REP, dict(pshard), dict(pshard))
        step = TS.make_xdeepfm_train_step(cfg, opt)
        batch = {"ids": _meta((b, cfg.n_sparse), torch.int32),
                 "labels": _meta((b,), torch.float32)}
        bshard = {"ids": Spec((ba, None)), "labels": Spec((ba,))}
        flops = _recsys_flops(cfg, b) * 3.0

        def modeled(census):
            lookups(census, b // dp, 2)
            _grad_sync(census, params, pshard, mesh, ba)

        return CellPlan(arch, shape, step, (params, opt_state, batch),
                        (pshard, oshard, bshard), (pshard, oshard, REP), flops,
                        compute_shards=dp, modeled=modeled)

    if cell.kind == "serve":
        b = cell.dims["batch"]
        step = TS.make_xdeepfm_serve_step(cfg)
        ids = _meta((b, cfg.n_sparse), torch.int32)
        flops = _recsys_flops(cfg, b)
        return CellPlan(arch, shape, step, (params, ids), (pshard, Spec((ba, None))),
                        Spec((ba,)), flops, compute_shards=dp,
                        modeled=lambda census: lookups(census, b // dp, 1))

    # retrieval: 1 query vs n_candidates
    nc = _pad_to(cell.dims["n_candidates"], nd)
    d_out = cfg.mlp_layers[-1]
    step = TS.make_retrieval_step(cfg)
    q = _meta((1, cfg.n_sparse), torch.int32)
    cand = _meta((nc, d_out), torch.float32)
    flops = 2.0 * nc * d_out + _recsys_flops(cfg, 1)
    return CellPlan(arch, shape, step, (params, q, cand),
                    (pshard, REP, Spec((all_axes, None))), Spec((all_axes,)), flops,
                    compute_shards=nd, modeled=lambda census: lookups(census, 1, 1))


def _recsys_flops(cfg, b) -> float:
    d = cfg.embed_dim
    f0 = cfg.n_sparse
    total = 0.0
    prev = f0
    for h in cfg.cin_layers:
        total += 2.0 * b * h * f0 * prev * d
        prev = h
    dims = [f0 * d] + list(cfg.mlp_layers) + [1]
    for a, c in zip(dims[:-1], dims[1:]):
        total += 2.0 * b * a * c
    return total


# ---------------------------------------------------------------------------
# Graph500 (the paper's own workload)
# ---------------------------------------------------------------------------

def graph500_level(gm: Mesh, *, w_loc: int, exchange: str):
    """One level body of the vertex-sharded engine over every shard of the
    virtual ``(group, member)`` mesh ``gm``: each shard relaxes all its
    dst-owned edge chunks against the replicated frontier (the owned-edge
    relax, no heavy core), packs its delta words, the shards exchange them
    (``_exchange_delta``), the level's sums cross the mesh (``psum``) and
    each shard's visited words take the frontier update.

    step(root, src, dst_local, valid, src_lo, src_hi, degree_local,
    n_active) -> (parent, level, in_count, sentinel mask), the inputs the
    JAX package's engine takes, shaped ``[n_dev, ...]``."""
    from repro_torch.comms.mesh import VertexComm
    from repro_torch.core.heavy import pack_bitmap
    from repro_torch.core.hybrid_bfs import _exchange_delta, _relax_owned_edges
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.bitmap_ops import WORDS_PER_TILE
    from repro_torch.kernels.ref import popcount_u32

    comm = VertexComm(gm)
    n_dev = comm.n
    v_loc = 32 * w_loc
    v_pad = n_dev * v_loc
    i32 = torch.int32

    def step(root, src, dst_local, valid, src_lo, src_hi, degree_local, n_active):
        dev = src.device
        frontier = torch.zeros(n_dev * w_loc, dtype=i32, device=dev)
        parents, newlys, deltas, visited = [], [], [], []
        for d in comm.local:
            vis = torch.zeros(w_loc, dtype=i32, device=dev)
            old = torch.full((v_loc,), v_pad, dtype=i32, device=dev)
            p = old.clone()
            _relax_owned_edges(src[d].reshape(-1), dst_local[d].reshape(-1),
                               valid[d].reshape(-1), frontier, vis, p, v_pad)
            newly = (p != v_pad) & (old == v_pad)
            parents.append(p)
            newlys.append(newly)
            deltas.append(pack_bitmap(newly, w_loc))
            visited.append(vis)
        next_bms = _exchange_delta(comm, deltas, w_loc=w_loc, n_dev=n_dev,
                                   exchange=exchange, known=[frontier] * n_dev)
        in_count = popcount_u32(next_bms[0]).sum()
        sums = [torch.stack([popcount_u32(delta).sum(),
                             popcount_u32(nb[d * w_loc:(d + 1) * w_loc] & vis).sum(),
                             torch.where(newly, degree_local[d], 0).sum(),
                             torch.zeros((), dtype=torch.int64, device=dev)])
                for d, nb, vis, newly, delta in zip(comm.local, next_bms, visited,
                                                    newlys, deltas)]
        delta_sum, overlap, _, _ = comm.psum(sums).to(i32)
        ok = (in_count.to(i32) == delta_sum).to(i32) + 2 * (overlap == 0).to(i32)
        if w_loc % WORDS_PER_TILE == 0:
            visited = [kops.frontier_update(delta, vis)[1]
                       for delta, vis in zip(deltas, visited)]
        else:
            visited = [vis | delta for delta, vis in zip(deltas, visited)]
        levels = torch.stack([torch.where(newly, 1, -1).to(i32) for newly in newlys])
        return torch.stack(parents), levels, in_count.to(i32), ok

    return step


def graph500_cell(arch: str, shape: str, mesh: Mesh, variant: str = "baseline") -> CellPlan:
    """One level body of the vertex-sharded engine (:func:`graph500_level`)
    on the production mesh, with the group role spanning the batch axes
    (``("pod", "data")`` on the multi-pod mesh) and the member role on
    ``model``.  Inputs are a dst-owned ``ShardedGraph`` partition's (block
    word ownership; src-sorted chunks), as the JAX package's cell lowers
    them.

    ``variant``: ``baseline`` runs ``exchange="hier_or"`` (the T3
    two-phase OR); ``gather*`` the hierarchical all-gather; ``*flat*`` the
    flat ablation; ``tuned`` the exchange the port's tuner persisted in
    ``TUNED_PLANS_torch.json`` (nearest tuned scale), ``hier_or`` with no
    table.
    """
    from repro_torch.core.bfs_steps import DEFAULT_CHUNKS
    from repro_torch.core.heavy import padded_bitmap_words

    spec = get(arch)
    cell = spec.shape(shape)
    scale, ef = cell.dims["scale"], cell.dims["edge_factor"]
    multi, _ = _axes(mesh)
    nd = math.prod(mesh.shape)
    v = 1 << scale
    e_directed = 2 * ef * v

    # dst-owned block-word partition geometry (distributed_bfs.shard_graph)
    w_loc = -(-padded_bitmap_words(v) // nd)
    v_loc = 32 * w_loc
    n_chunks = DEFAULT_CHUNKS
    chunk_size = max(128, -(-int(1.1 * e_directed / nd) // n_chunks))

    gaxes = ("pod", "data") if multi else ("data",)
    mesh_axes = gaxes + ("model",)
    shard0 = Spec((mesh_axes,))

    exchange_src = ""
    if "flat" in variant:
        exchange = "flat"
    elif "gather" in variant:
        exchange = "hier_gather"
    elif variant == "tuned":
        from repro_torch.core.tune import tuned_exchange
        exchange, src = tuned_exchange(scale, nd)
        exchange_src = f";exchange_source={src}"
    else:
        exchange = "hier_or"

    gm = make_mesh((_size(mesh, gaxes), mesh.size("model")), ("group", "member"),
                   device=mesh.devices[0], virtual=True)
    step = graph500_level(gm, w_loc=w_loc, exchange=exchange)
    e_meta = (nd, n_chunks, chunk_size)
    args = (
        _meta((), torch.int32),                         # root
        _meta(e_meta, torch.int32),                     # src (global ids)
        _meta(e_meta, torch.int32),                     # dst_local
        _meta(e_meta, torch.bool),                      # valid
        _meta((nd, n_chunks), torch.int32),             # src_lo
        _meta((nd, n_chunks), torch.int32),             # src_hi
        _meta((nd, v_loc), torch.int32),                # degree_local
        _meta((), torch.int32),                         # n_active
    )
    in_sh = (REP, shard0, shard0, shard0, shard0, shard0, shard0, REP)
    out_sh = (shard0, shard0, REP, REP)  # parent, level, in_count, sentinel
    flops = 2.0 * e_directed  # semiring "flops": one AND+OR per edge/level-ish
    return CellPlan(arch, shape, step, args, in_sh, out_sh, flops,
                    note=f"variant={variant};exchange={exchange}"
                         f"{exchange_src};"
                         f"plan=vertex_sharded_program(w_loc={w_loc})",
                    compute_shards=nd)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape: str, mesh: Mesh, variant: str = "baseline") -> CellPlan:
    family = get(arch).family
    fn = {"lm": lm_cell, "gnn": gnn_cell, "recsys": recsys_cell,
          "graph500": graph500_cell}[family]
    return fn(arch, shape, mesh, variant)
