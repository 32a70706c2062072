"""End-to-end Graph500 pipeline (steps 1-4) with the paper's option ladder.

Counterpart of ``repro.core.pipeline`` for the single-device rungs, the
four of Fig. 18 and three more:

  reference-3.0.0 : no sort, no core, the reference engine;
  th2             : degree sort (T2a), the reference engine;
  k               : degree sort + the hybrid switch tuned (alpha 8, beta 64);
  pre-g500        : degree sort + heavy core (T2b) + the bitmap-resident
                    engine with the hand-written kernels (T1), one timed
                    traversal per root;
  pre-g500-legacy : the pre-resident loop (bool frontier re-packed every
                    bottom-up level for the ``core_spmv`` kernel, every
                    edge scanned top-down), the measured "before";
  pre-g500-batch  : the bitmap engine over the whole root batch, timed as
                    one batch (wall-clock / n per search);
  pre-g500-tuned  : the auto-tuner's winner for (scale, devices, backend)
                    from the port's tuned-plan table
                    (:mod:`repro_torch.core.tune`), ``pre-g500-batch``'s
                    plan when the table has no matching entry.

and the two mesh rungs:

  pre-g500-mesh   : ``pre-g500-batch``'s roots split over a ``("root",)``
                    mesh of every visible device (``root_devices`` sizes it);
  pre-g500-mesh3  : the composed ``("root", "group", "member")`` layout, one
                    root lane over the vertex-sharded mesh of
                    ``plan_device_mesh`` unless ``mesh_shape`` is given.

``kernel="sssp"`` runs Graph500's second kernel, δ-stepping SSSP, on the
same graph with a weight plane seeded from ``seed``.  ``retries`` and
``fallback`` arm the checked run's recovery; :func:`serve` stands up the
serving engine on the same graph and plan.  ``procs > 1`` hands
:func:`run` to the multi-process launcher
(:mod:`repro_torch.launch.multiprocess`); ``run(mesh=)`` runs the plan on a
given mesh (a virtual one, say).  Everything runs on the card unless
``Graph500Config.device`` says ``"cpu"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import kronecker
from repro_torch.core.bfs_steps import EdgeView, edge_view, with_edge_weights
from repro_torch.core.distributed_bfs import ShardedGraph, shard_graph
from repro_torch.core.graph_build import DEFAULT_MAX_WEIGHT, build_csr
from repro_torch.core.heavy import HeavyCore, build_heavy_core
from repro_torch.core.kronecker import EdgeList
from repro_torch.core.plan import BFSPlan, compile_plan
from repro_torch.core.reorder import Reordering, degree_reorder, relabel_edges
from repro_torch.core.teps import Graph500Run
from repro_torch.util import resolve_device

_PORTED_RUNGS = {
    "reference-3.0.0": dict(degree_sort=False, heavy_threshold=None,
                            engine="reference"),
    "th2": dict(degree_sort=True, heavy_threshold=None, engine="reference"),
    "k": dict(degree_sort=True, heavy_threshold=None, engine="reference",
              alpha=8.0, beta=64.0),
    "pre-g500-legacy": dict(degree_sort=True, heavy_threshold=100,
                            engine="legacy"),
    "pre-g500": dict(degree_sort=True, heavy_threshold=100, engine="bitmap"),
    "pre-g500-batch": dict(degree_sort=True, heavy_threshold=100,
                           engine="bitmap", batched=True),
    # the roots over a ("root",) mesh of every visible device unless
    # root_devices says otherwise
    "pre-g500-mesh": dict(degree_sort=True, heavy_threshold=100,
                          engine="bitmap", batched=True, root_devices=0),
    # the root lanes outside the vertex-sharded traversal
    "pre-g500-mesh3": dict(degree_sort=True, heavy_threshold=100,
                           engine="bitmap", batched=True,
                           layout=("root", "group", "member")),
    "pre-g500-tuned": dict(degree_sort=True, heavy_threshold=100,
                           engine="bitmap", batched=True, tuned=True),
}


@dataclass(frozen=True)
class Graph500Config:
    scale: int = 12
    edge_factor: int = 16
    seed: int = 42
    n_roots: int = 8
    degree_sort: bool = True
    heavy_threshold: Optional[int] = 100   # None disables the dense core
    engine: str = "bitmap"                 # "reference" | "legacy" | "bitmap"
    alpha: float = 14.0
    beta: float = 24.0
    batched: bool = False                  # time the root batch as one
    # Mesh sharding: root_devices shards the root batch over a ("root",)
    # mesh of that many devices (0: all visible); layout/mesh_shape give
    # the plan's layout explicitly (None keeps the knob derivation, ()
    # forces one device).  partition is the vertex-ownership map of the
    # sharded engine ("block" | "word_cyclic").
    root_devices: Optional[int] = None
    layout: Optional[tuple] = None
    mesh_shape: Optional[tuple] = None
    exchange: str = "hier_or"
    partition: str = "block"
    # Auto-tuned plan: start from the tuned-plan table's winner for
    # (scale, the devices of ``device``, backend).  An explicit layout /
    # mesh_shape / root_devices bypasses the table; non-default
    # engine/exchange/partition/alpha/beta knobs override those fields of
    # the tuned plan; with no matching entry the untuned derivation holds.
    tuned: bool = False
    check: str = "post"                    # "off" | "post" | "full"
    # Checked-execution recovery: the per-root retry budget, and whether
    # still-failing roots re-run on the degraded single-device plan before
    # quarantine.
    retries: int = 0
    fallback: bool = False
    # Graph500 kernel: "bfs" or "sssp".  Under "sssp" the build attaches the
    # symmetric weight plane (seeded from ``seed``, uniform in
    # [1, max_weight]) and the plan runs the δ-stepping engine.
    kernel: str = "bfs"
    max_weight: int = DEFAULT_MAX_WEIGHT
    device: Optional[str] = None           # None: the card ("cuda")
    # Multi-process runtime: procs > 1 hands ``run`` to the launcher
    # (repro_torch.launch.multiprocess), one gloo process per monitor group
    # with devices_per_proc (None: 1) member shards each; only ``run``
    # honours these.
    procs: int = 1
    devices_per_proc: Optional[int] = None

    @staticmethod
    def ladder(rung: str, **kw) -> "Graph500Config":
        if rung not in _PORTED_RUNGS:
            raise ValueError(f"unknown rung {rung!r}; expected one of "
                             f"{sorted(_PORTED_RUNGS)}")
        return Graph500Config(**{**_PORTED_RUNGS[rung], **kw})

    def to_plan(self) -> BFSPlan:
        """Lower the config knobs onto the declarative plan axes.

        With ``tuned=True`` the plan starts from the tuned-plan table's
        winner: an explicit layout / mesh_shape / root_devices bypasses
        the table entirely, non-default engine/exchange/partition/alpha/
        beta knobs replace those fields, and the table's ``batch_roots``
        is kept (tuned winners are batched plans).
        """
        if (self.tuned and self.layout is None and self.mesh_shape is None
                and self.root_devices is None):
            from repro_torch.core.tune import device_view, tuned_plan

            defaults = Graph500Config()
            overrides = {
                f: getattr(self, f)
                for f in ("engine", "exchange", "partition", "alpha", "beta")
                if getattr(self, f) != getattr(defaults, f)
            }
            n_devices, backend = device_view(self.device)
            base = tuned_plan(self.scale, n_devices, backend,
                              overrides=overrides, kernel=self.kernel)
            if base is not None:
                return base
        if self.layout is not None:
            layout, mesh_shape = tuple(self.layout), self.mesh_shape
        elif self.root_devices is not None:
            if not self.batched:
                raise ValueError(
                    "root_devices requires batched=True (the mesh shards "
                    "the batched harness's root vector)")
            layout = ("root",)
            mesh_shape = (self.root_devices,) if self.root_devices else None
        else:
            layout, mesh_shape = (), None
        return BFSPlan(
            engine=self.engine, layout=layout, mesh_shape=mesh_shape,
            exchange=self.exchange, partition=self.partition,
            alpha=self.alpha, beta=self.beta,
            batch_roots=self.batched, kernel=self.kernel,
        )


@dataclass
class BuiltGraph:
    ev: EdgeView
    degree: torch.Tensor
    core: Optional[HeavyCore]
    reorder: Optional[Reordering]
    construction_s: float
    n_vertices: int
    nnz: int
    edges: EdgeList   # the input edge list, original labels (root sampling)
    sharded: Optional[ShardedGraph] = None   # the partition of build(mesh=)


def build(cfg: Graph500Config, edges: EdgeList | None = None,
          mesh=None) -> BuiltGraph:
    """Steps 1-2 on ``cfg.device`` (untimed for TEPS; construction time is
    recorded).  ``edges`` replaces the generated Kronecker edge list.  A
    ``mesh`` with a ``member`` axis also partitions the graph over its
    vertex shards (``cfg.partition``), which ``compile_plan`` then uses."""
    device = resolve_device(cfg.device)
    t0 = time.perf_counter()
    if edges is None:
        edges = kronecker.generate_edges(cfg.seed, cfg.scale, cfg.edge_factor,
                                         device=device)
    elif edges.src.device.type != device.type:
        raise ValueError(f"edges lie on {edges.src.device}, cfg.device is {device}")
    g = build_csr(edges)
    reord = None
    if cfg.degree_sort:
        reord = degree_reorder(g.degree)
        g = build_csr(relabel_edges(edges, reord))
    core = None
    if cfg.heavy_threshold is not None:
        core = build_heavy_core(g, threshold=cfg.heavy_threshold)
    ev = edge_view(g)
    if cfg.kernel == "sssp":
        # the weights hash the relabelled endpoint ids, which the oracle and
        # every engine see alike
        ev = with_edge_weights(ev, seed=cfg.seed, max_weight=cfg.max_weight)
    sharded = None
    if mesh is not None and "member" in mesh.axis_names:
        sharded = shard_graph(
            ev.src, ev.dst, ev.valid, ev.num_vertices,
            mesh.size("group") * mesh.size("member"), partition=cfg.partition,
            weight=ev.weight if cfg.kernel == "sssp" else None, device=device)
    nnz = int(g.nnz)  # synchronises: construction ends here
    return BuiltGraph(ev=ev, degree=g.degree, core=core, reorder=reord,
                      construction_s=time.perf_counter() - t0,
                      n_vertices=g.num_vertices, nnz=nnz, edges=edges,
                      sharded=sharded)


def search_keys(cfg: Graph500Config, built: BuiltGraph, roots=None) -> np.ndarray:
    """The search keys as ids of the built (relabeled) graph.

    ``roots`` are ids in the input edge list's labels (default:
    ``cfg.n_roots`` sampled from it); the degree sort's relabeling maps
    them onto the sorted graph, as in the JAX pipeline.
    """
    if roots is None:
        roots = kronecker.sample_roots(cfg.seed, built.edges, cfg.n_roots)
    if not isinstance(roots, torch.Tensor):
        roots = torch.from_numpy(np.array(roots, dtype=np.int64))
    roots = roots.to(built.degree.device).long()
    if built.reorder is not None:
        roots = built.reorder.new_from_old[roots]
    return roots.cpu().numpy()


def run(cfg: Graph500Config, built: BuiltGraph | None = None,
        roots=None, mesh=None) -> tuple[BuiltGraph, Graph500Run]:
    """Steps 3-4: compile the config's plan (on ``mesh`` when one is given)
    and run the timed harness over :func:`search_keys`.

    ``cfg.procs > 1`` delegates to the multi-process launcher: the traversal
    runs on ``procs`` gloo processes, which build the graph and sample the
    roots themselves from the config (so ``roots`` and ``mesh`` must be
    None), and rank 0's :class:`Graph500Run` comes back beside ``built``.
    """
    if cfg.procs > 1:
        if roots is not None or mesh is not None:
            raise ValueError("procs > 1 runs the config in worker processes, "
                             "which sample the roots and lay the mesh: pass "
                             "neither roots nor mesh")
        from repro_torch.launch.multiprocess import run_config

        return run_config(cfg, built)
    built = built or build(cfg)
    compiled = compile_plan(cfg.to_plan(), built, device=cfg.device, mesh=mesh)
    return built, compiled.run(search_keys(cfg, built, roots), check=cfg.check,
                               retries=cfg.retries, fallback=cfg.fallback).run


def serve(cfg: Graph500Config, serve_cfg=None, built: BuiltGraph | None = None,
          fault=None):
    """Stand up the persistent serving engine on this config's graph and
    plan: build once, compile once; returns ``(built, engine)``, and traces
    go to ``engine.serve``.

    ``serve_cfg`` is a :class:`repro_torch.serve.engine.ServeConfig`
    (defaults apply when None, with ``cfg.check``/``cfg.retries``).  The
    plan is :meth:`Graph500Config.to_plan` with ``batch_roots`` forced on
    by the engine (the tuned winner under ``cfg.tuned``, as offline); it
    runs on ``cfg.device``.  ``fault`` is threaded into
    every traversal (:mod:`repro_torch.core.faults`).
    """
    from repro_torch.serve.engine import Engine, ServeConfig

    built = built or build(cfg)
    if serve_cfg is None:
        serve_cfg = ServeConfig(check=cfg.check, retries=cfg.retries)
    engine = Engine(built, plan=cfg.to_plan(), config=serve_cfg, fault=fault,
                    device=cfg.device)
    return built, engine
