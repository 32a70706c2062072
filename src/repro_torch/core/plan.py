"""Declarative spec -> plan -> runner API for the Graph500 engines.

Counterpart of ``repro.core.plan``:

  1. **spec** — :class:`TraversalPlan` (alias ``BFSPlan``), the same frozen
     dataclass with the same fields, ``to_dict``/``from_dict`` and the same
     rejection of unknown fields.
  2. **plan** — :func:`compile_plan` validates the spec, resolves the
     device and the mesh, prepares the graph (the chunked edge view, or the
     dst-owned shard partition of a vertex-sharded layout) and returns a
     :class:`CompiledBFS`.
  3. **runner** — :meth:`CompiledBFS.run` is the Graph500 timed harness:
     warm-up outside the timed region, spec validation, harmonic-mean TEPS,
     whatever the layout.

Layouts, every one bitwise equal to the single-device bitmap engine:

  ``()``                          one device, every engine of the BFS kernel
                                  (``bitmap``, ``reference``, ``legacy``)
                                  and the SSSP kernel's ``bitmap``;
  ``("root",)``                   roots split over the root axis, the graph
                                  replicated (shared by reference on a
                                  virtual mesh), no communication;
  ``("group", "member")``         one traversal vertex-sharded over the
                                  monitor-group mesh, the per-level deltas
                                  combined by the T3 exchange
                                  (``hybrid_bfs._run_bitmap_sharded``,
                                  ``sssp_steps._run_sssp_sharded``);
  ``("root", "group", "member")`` both: each root lane runs the
                                  vertex-sharded traversal of its roots.

The mesh is :mod:`repro_torch.comms.mesh`'s: ``compile_plan(mesh=None)``
lays one over the visible devices (one shard per card; too few is JAX's
``ValueError``), or, inside an initialised ``torch.distributed`` group, a
process mesh with ``group`` on the processes; a virtual mesh (every shard
on one device) is passed in as ``mesh=``.  Checked execution: ``check`` in
off|post|full, fault injection (``compile_plan(fault=)``,
:mod:`repro_torch.core.faults`) and the detect -> retry -> degraded
fallback -> quarantine recovery of :meth:`CompiledBFS.run`, with its untimed
serving primitive :meth:`CompiledBFS.serve_batch`.  ``batch_roots=True``
(bitmap engine only, as in the JAX package) runs the roots one after
another through the per-root engine and keeps the batched timing convention
(wall-clock / n).
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.comms.mesh import Mesh, VertexComm, dist_world, make_mesh
from repro_torch.comms.topology import plan_device_mesh
from repro_torch.core.bfs_steps import (
    DEFAULT_CHUNKS, ChunkedEdgeView, EdgeView, chunk_edge_view,
)
from repro_torch.core.distributed_bfs import (
    PARTITIONS, ShardedGraph, partition_permutation, shard_graph,
)
from repro_torch.core.heavy import HeavyCore
from repro_torch.core.hybrid_bfs import (
    MAX_LEVELS, SENTINEL_OK, BFSResult, _run_batch, _run_bitmap_impl,
    _run_bitmap_sharded, _run_legacy, bottom_up_tail, shard_inputs, stack_results,
)
from repro_torch.core.kernels import kernel_spec, validate_result_batch
from repro_torch.core.sssp_steps import (
    _run_sssp_batch, _run_sssp_impl, _run_sssp_sharded, bucket_width,
    sssp_max_rounds,
)
from repro_torch.core.teps import Graph500Run, traversed_edges
from repro_torch.core.validate import failure_report
from repro_torch.util import resolve_device

VALID_LAYOUTS = (
    (),
    ("root",),
    ("group", "member"),
    ("root", "group", "member"),
)


# ---------------------------------------------------------------------------
# 1. Spec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TraversalPlan:
    """Frozen declarative spec of one Graph500 traversal execution (the
    fields of ``repro.core.plan.TraversalPlan``)."""

    engine: str = "bitmap"
    layout: tuple = ()
    mesh_shape: Optional[tuple] = None
    exchange: str = "hier_or"
    partition: str = "block"
    alpha: float = 14.0
    beta: float = 24.0
    max_levels: int = MAX_LEVELS
    n_chunks: int = DEFAULT_CHUNKS
    batch_roots: bool = True
    kernel: str = "bfs"

    def __post_init__(self):
        object.__setattr__(self, "layout", tuple(self.layout))
        if self.mesh_shape is not None:
            object.__setattr__(
                self, "mesh_shape", tuple(int(s) for s in self.mesh_shape))
        if self.kernel == "sssp" and self.exchange == "hier_or":
            object.__setattr__(self, "exchange", "hier_min")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["layout"] = list(self.layout)
        d["mesh_shape"] = (list(self.mesh_shape)
                           if self.mesh_shape is not None else None)
        return d

    @staticmethod
    def from_dict(d: dict) -> "TraversalPlan":
        """Inverse of :meth:`to_dict`; unknown keys are rejected, missing
        keys default-fill."""
        fields = {f.name for f in dataclasses.fields(TraversalPlan)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown BFSPlan fields {sorted(unknown)}; "
                             f"expected a subset of {sorted(fields)}")
        return TraversalPlan(**d)


BFSPlan = TraversalPlan


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


class ShardedRun(NamedTuple):
    """Raw vertex-sharded output in padded global vertex order."""

    parent: torch.Tensor   # [..., V_pad] int32, -1 unvisited
    level: torch.Tensor    # [..., V_pad] int32 (SSSP: distances, -1 unreached)
    levels: torch.Tensor   # per-root levels (rounds) run
    sentinel: Any = None   # [..., max_levels] int32 in-loop sentinel masks


def visible_devices(device) -> int:
    """The devices a plan on ``device`` can lay a mesh over: every visible
    card on ``cuda``, one on ``cpu``."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def _mesh_shape(plan: TraversalPlan, n_avail: int) -> tuple:
    """The mesh shape of a layout plan on ``n_avail`` devices: the plan's
    own, else the one JAX's ``compile_plan`` derives (all devices on the
    root axis; :func:`plan_device_mesh`'s (group, member) split under one
    root lane).  ValueErrors, with JAX's texts, when the planner's member
    axis is not a power of two or the shape needs more devices than there
    are."""
    shape = plan.mesh_shape
    if shape is None:
        if plan.layout == ("root",):
            shape = (n_avail,)
        elif plan.layout == ("group", "member"):
            shape = plan_device_mesh(n_avail)
        else:   # composed 3-axis: one root lane over the planned vertex mesh
            shape = (1,) + plan_device_mesh(n_avail)
        if "member" in plan.layout:
            m = shape[plan.layout.index("member")]
            if not _is_pow2(m):
                raise ValueError(
                    f"plan_device_mesh({n_avail}) yields a member axis of "
                    f"{m} (not a power of two); pass an explicit "
                    f"mesh_shape for this device count")
    need = math.prod(shape)
    if need > n_avail:
        raise ValueError(
            f"plan layout {plan.layout} with mesh shape {shape} needs "
            f"{need} devices, have {n_avail} — shrink mesh_shape")
    return shape


def validate_plan(plan: TraversalPlan) -> None:
    """The JAX package's field checks (no devices touched), all ValueErrors,
    with the engine and exchange vocabularies from the plan's kernel row."""
    spec = kernel_spec(plan.kernel)     # rejects unknown kernels
    if plan.engine not in spec.engines:
        raise ValueError(f"unknown engine {plan.engine!r} for kernel "
                         f"{plan.kernel!r}; expected one of {spec.engines}")
    if plan.layout not in VALID_LAYOUTS:
        raise ValueError(f"unknown layout {plan.layout!r}; expected one of "
                         f"{VALID_LAYOUTS}")
    if plan.exchange not in spec.shard_exchanges:
        raise ValueError(f"unknown exchange {plan.exchange!r} for kernel "
                         f"{plan.kernel!r}; expected one of {spec.shard_exchanges}")
    if plan.partition not in PARTITIONS:
        raise ValueError(f"unknown partition {plan.partition!r}; expected "
                         f"one of {PARTITIONS}")
    if plan.partition != "block" and "member" not in plan.layout:
        raise ValueError(f"partition={plan.partition!r} requires a "
                         f"vertex-sharded layout (a 'member' axis)")
    if plan.layout and plan.engine != "bitmap":
        raise ValueError(f"mesh layout {plan.layout} requires engine='bitmap' "
                         f"(got {plan.engine!r}); the legacy engines are "
                         f"single-device")
    if "root" in plan.layout and not plan.batch_roots:
        raise ValueError("layout with a 'root' axis requires batch_roots=True")
    if plan.batch_roots and plan.engine != "bitmap":
        raise ValueError(f"batch_roots=True requires engine='bitmap' (got "
                         f"{plan.engine!r}); use batch_roots=False for "
                         f"per-root runs")
    if plan.mesh_shape is not None:
        if not plan.layout:
            raise ValueError("mesh_shape given but layout is () (single "
                             "device has no mesh)")
        if len(plan.mesh_shape) != len(plan.layout):
            raise ValueError(f"mesh_shape {plan.mesh_shape} does not match "
                             f"layout {plan.layout} (need one size per axis)")
        if any(s < 1 for s in plan.mesh_shape):
            raise ValueError(f"mesh_shape sizes must be >= 1, got "
                             f"{plan.mesh_shape}")
        if "member" in plan.layout:
            m = plan.mesh_shape[plan.layout.index("member")]
            if not _is_pow2(m):
                raise ValueError(
                    f"member axis size {m} is not a power of two; the "
                    f"plan API requires pow2 members so the two-phase "
                    f"monitor collectives halve cleanly")
    if plan.n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {plan.n_chunks}")


def _resolve_mesh(plan: TraversalPlan, mesh: Optional[Mesh], dev) -> Optional[Mesh]:
    """The plan's mesh: ``mesh`` checked against the layout (its axes must
    be the layout's, its sizes ``plan.mesh_shape`` when one is given), else
    one built over the visible devices of ``dev``.  Inside an initialised
    ``torch.distributed`` group a layout with a ``group`` axis gets a
    process mesh: ``group`` on the processes, ``member`` (default 1) shards
    per process on ``dev``."""
    if not plan.layout:
        if mesh is not None:
            raise ValueError("plan layout is () (single device) but a mesh "
                             "was passed")
        return None
    if mesh is not None:
        if tuple(mesh.axis_names) != plan.layout:
            raise ValueError(f"mesh axes {tuple(mesh.axis_names)} do not cover "
                             f"the plan layout axes {plan.layout}")
        if plan.mesh_shape is not None and tuple(mesh.shape) != plan.mesh_shape:
            raise ValueError(f"mesh sizes {tuple(mesh.shape)} do not match "
                             f"plan.mesh_shape {plan.mesh_shape}")
        return mesh
    _, world = dist_world()
    if world > 1 and "group" in plan.layout:
        shape = plan.mesh_shape
        if shape is None:
            shape = (world, 1) if plan.layout == ("group", "member") else (1, world, 1)
        return make_mesh(shape, plan.layout, device=dev, virtual=True)
    return make_mesh(_mesh_shape(plan, visible_devices(dev)), plan.layout, device=dev)


@dataclass
class PreparedGraph:
    """Graph-side inputs for :func:`compile_plan` (``pipeline.BuiltGraph``
    qualifies too)."""

    ev: Optional[EdgeView] = None
    degree: Optional[torch.Tensor] = None
    core: Optional[HeavyCore] = None
    chunks: Optional[ChunkedEdgeView] = None
    sharded: Optional[ShardedGraph] = None


class ServeBatch(NamedTuple):
    """Checked, untimed solve of one root batch for the serving engine:
    numpy rows in batch order plus the detection report.  ``failures``
    maps batch-row index -> failed check names for the rows still failing
    after any retry/fallback recovery."""

    parent: np.ndarray          # [B, V] int32
    level: np.ndarray           # [B, V] int32
    counts: dict                # check name -> failing rows at detection
    failures: dict              # row index -> failed check names (final)


@dataclass
class Graph500Result:
    """Uniform runner output."""

    parent: np.ndarray          # [R, V] int32
    level: np.ndarray           # [R, V] int32 (SSSP: the distance plane)
    run: Graph500Run
    plan: TraversalPlan
    mesh_axes: Optional[dict] = None   # {axis: size} of the plan's mesh


# ---------------------------------------------------------------------------
# 2. compile_plan + the runner
# ---------------------------------------------------------------------------

def _prepare(built, plan: TraversalPlan, dev, n_dev_vertex: int) -> PreparedGraph:
    """The graph-side inputs of ``plan``: ``built``'s, with the chunked edge
    view (single-device and root layouts) or the dst-owned shard partition
    (vertex-sharded layouts) built when missing, and JAX's ValueErrors."""
    pg = PreparedGraph(ev=getattr(built, "ev", None),
                       degree=getattr(built, "degree", None),
                       core=getattr(built, "core", None),
                       chunks=getattr(built, "chunks", None),
                       sharded=getattr(built, "sharded", None))
    needs_w = kernel_spec(plan.kernel).needs_weights
    if needs_w and pg.ev is not None and pg.ev.weight is None:
        raise ValueError(f"kernel={plan.kernel!r} needs edge weights: attach "
                         f"them with with_edge_weights(ev) before compiling "
                         f"the plan")
    for name, t in (("ev.src", pg.ev.src if pg.ev else None), ("degree", pg.degree),
                    ("core.a_core", pg.core.a_core if pg.core else None),
                    ("sharded.src", pg.sharded.src if pg.sharded else None)):
        if t is not None and t.device.type != dev.type:
            raise ValueError(f"built.{name} lies on {t.device}, the plan runs "
                             f"on {dev}: build the graph on the same device")
    if "member" in plan.layout:
        if pg.sharded is None:
            if pg.ev is None:
                raise ValueError("vertex-sharded plan needs built.ev (an "
                                 "EdgeView) or a pre-built ShardedGraph "
                                 "(built.sharded)")
            pg.sharded = shard_graph(
                pg.ev.src, pg.ev.dst, pg.ev.valid, pg.ev.num_vertices,
                n_dev_vertex, plan.n_chunks, partition=plan.partition,
                weight=pg.ev.weight if needs_w else None, device=dev)
        elif pg.sharded.n_devices != n_dev_vertex:
            raise ValueError(f"ShardedGraph was partitioned for "
                             f"{pg.sharded.n_devices} devices but the plan mesh "
                             f"has {n_dev_vertex} (group x member)")
        elif pg.sharded.partition != plan.partition:
            raise ValueError(f"ShardedGraph was partitioned with partition="
                             f"{pg.sharded.partition!r} but the plan says "
                             f"{plan.partition!r}: re-run shard_graph (the "
                             f"owner map is baked into the edge split)")
        if needs_w and pg.sharded.weight is None:
            raise ValueError(f"kernel={plan.kernel!r} needs a weighted "
                             f"ShardedGraph: pass weight= to shard_graph (or "
                             f"let compile_plan shard a weighted EdgeView)")
        return pg
    if pg.ev is None:
        raise ValueError("plan needs built.ev (an EdgeView)")
    if pg.degree is None:
        raise ValueError("plan needs built.degree")
    if plan.engine == "bitmap" and (
            pg.chunks is None or pg.chunks.n_chunks != plan.n_chunks
            or (needs_w and pg.chunks.weight is None)):
        pg.chunks = chunk_edge_view(pg.ev, plan.n_chunks)
    return pg


def compile_plan(plan: TraversalPlan, built, *, device=None, mesh: Optional[Mesh] = None,
                 fault=None) -> "CompiledBFS":
    """Validate ``plan`` and prepare the graph for it on ``device``.

    ``device=None`` means the card, and raises without one; the graph's
    tensors must already lie on the resolved device.  ``mesh`` (a
    :class:`~repro_torch.comms.mesh.Mesh`, e.g. a virtual one) must have the
    layout's axes, and ``plan.mesh_shape``'s sizes when that is given;
    ``None`` lays a mesh over the visible devices (a process mesh inside a
    ``torch.distributed`` group).  The SSSP kernel needs the weight plane
    (``with_edge_weights``, or a weighted ``built.sharded``); its bucket
    width comes from the largest weight.  ``fault`` is a
    :class:`~repro_torch.core.faults.FaultSpec` threaded into every
    traversal of the plan (the legacy engines have no injection sites and
    reject one); ``None`` runs the clean traversal.
    """
    dev = resolve_device(device)
    validate_plan(plan)
    if fault is not None and plan.engine != "bitmap":
        raise ValueError(f"fault injection requires engine='bitmap' (got "
                         f"{plan.engine!r}); the legacy engines have no hooks")
    mesh = _resolve_mesh(plan, mesh, dev)
    vertexy = "member" in plan.layout
    n_dev_vertex = mesh.size("group") * mesh.size("member") if vertexy else 1
    pg = _prepare(built, plan, dev, n_dev_vertex)
    # The dense core is a boolean-semiring step with no weight plane: only
    # the BFS kernel consults it.
    core = pg.core if plan.kernel == "bfs" else None
    delta = max_rounds = 0
    tail = None
    if plan.kernel == "sssp":
        w = pg.ev.weight if pg.ev is not None else pg.sharded.weight
        delta = bucket_width(int(w.max()))
        max_rounds = sssp_max_rounds(plan.max_levels)
    elif plan.engine == "bitmap" and not vertexy:
        tail = bottom_up_tail(pg.chunks, core)
    compiled = CompiledBFS(
        plan=plan, graph=pg, device=dev,
        num_vertices=pg.sharded.v_orig if vertexy else pg.ev.num_vertices,
        n_active=pg.sharded.n_active if vertexy else int((pg.degree > 0).sum()),
        core=core, tail=tail, delta=delta, max_rounds=max_rounds, fault=fault,
        mesh=mesh)
    if mesh is not None:
        compiled._lanes = (_vertex_lanes(compiled) if vertexy
                           else _root_lanes(compiled))
    return compiled


def _root_lanes(c: "CompiledBFS") -> list:
    """One runner per root lane of a ``("root",)`` mesh: the single-device
    batch on the lane's device, over the graph (``.to`` copies nothing for
    a lane on the plan's device: every such lane shares it by reference;
    another card gets one copy)."""
    copies: dict = {}

    def on(dev):
        if dev not in copies:
            g = c.graph
            mv = (lambda t: None if t is None else t.to(dev))
            chunks = dataclasses.replace(
                g.chunks, **{f: mv(getattr(g.chunks, f)) for f in
                             ("src", "dst", "valid", "src_lo", "src_hi", "weight")})
            tail = None if c.tail is None else tuple(map(mv, c.tail))
            core = (None if c.core is None
                    else dataclasses.replace(c.core, a_core=mv(c.core.a_core)))
            copies[dev] = (chunks, mv(g.degree), core, tail)
        return copies[dev]

    p = c.plan
    lanes = []
    for dev in c.mesh.devices:
        chunks, degree, core, tail = on(dev)
        if p.kernel == "sssp":
            lanes.append(lambda roots, chunks=chunks, degree=degree: _run_sssp_batch(
                chunks, degree, roots, delta=c.delta, max_rounds=c.max_rounds,
                fault=c.fault))
        else:
            lanes.append(lambda roots, chunks=chunks, degree=degree, core=core, tail=tail:
                         _run_batch(chunks, degree, c.n_active, roots, core,
                                    alpha=p.alpha, beta=p.beta,
                                    max_levels=p.max_levels, tail=tail,
                                    fault=c.fault))
    return lanes


def _vertex_lanes(c: "CompiledBFS") -> list:
    """One runner per root lane of a vertex-sharded mesh: each root of the
    lane's slice through the sharded engine over the lane's vertex shards
    (shard inputs built once per (shard, device) and shared by the lanes)."""
    p, sg = c.plan, c.graph.sharded
    inputs: dict = {}
    lanes = []
    for r in range(c.mesh.size("root")):
        comm = VertexComm(c.mesh, r)
        shards = []
        for d, dev in zip(comm.local, comm.devices):
            if (d, dev) not in inputs:
                inputs[(d, dev)] = shard_inputs(sg, d, c.core, dev)
            shards.append(inputs[(d, dev)])
        if p.kernel == "sssp":
            def one(root, shards=shards, comm=comm):
                return _run_sssp_sharded(shards, comm, sg, root, delta=c.delta,
                                         max_rounds=c.max_rounds, exchange=p.exchange,
                                         fault=c.fault)
        else:
            def one(root, shards=shards, comm=comm):
                return _run_bitmap_sharded(shards, comm, sg, root, alpha=p.alpha,
                                           beta=p.beta, max_levels=p.max_levels,
                                           exchange=p.exchange, fault=c.fault)
        lanes.append(lambda roots, one=one: stack_results([one(int(r)) for r in roots]))
    return lanes


def _stack_runs(results: list) -> "ShardedRun":
    return ShardedRun(*(None if f[0] is None else torch.stack(f) for f in zip(*results)))


@dataclass
class CompiledBFS:
    """A validated plan bound to one prepared graph on one device (and, for
    a mesh layout, its mesh: every lane's runner in ``_lanes``)."""

    plan: TraversalPlan
    graph: PreparedGraph
    device: torch.device
    num_vertices: int           # original V (before any shard padding)
    n_active: int
    core: Optional[HeavyCore]   # the core the BFS engines consult, or None
    tail: Optional[tuple]       # bottom_up_tail of the bitmap BFS engine
    delta: int = 0              # SSSP bucket width
    max_rounds: int = 0         # SSSP round bound
    fault: Any = None           # the FaultSpec of every traversal, or None
    mesh: Optional[Mesh] = None
    _lanes: Optional[list] = field(default=None, repr=False)     # root-lane runners
    _fallback: Any = field(default=None, repr=False)  # degraded-plan CompiledBFS

    @property
    def mesh_axes(self) -> Optional[dict]:
        return None if self.mesh is None else self.mesh.axes

    @property
    def _vertexy(self) -> bool:
        return "member" in self.plan.layout

    def _traverse(self, root: int) -> BFSResult:
        """One traversal of the plan's kernel and engine from ``root`` on one
        device (the warm-up of a single-device plan)."""
        g, p = self.graph, self.plan
        if p.kernel == "sssp":
            return _run_sssp_impl(g.chunks, g.degree, root, delta=self.delta,
                                  max_rounds=self.max_rounds, fault=self.fault)
        if p.engine == "bitmap":
            return _run_bitmap_impl(g.chunks, g.degree, self.n_active, root,
                                    self.core, alpha=p.alpha, beta=p.beta,
                                    max_levels=p.max_levels, tail=self.tail,
                                    fault=self.fault)
        return _run_legacy(g.ev, g.degree, self.n_active, root, self.core,
                           engine=p.engine, alpha=p.alpha, beta=p.beta,
                           max_levels=p.max_levels)

    def _run_lanes(self, roots: list):
        """The roots split over the root lanes (padded with ``roots[0]`` to a
        multiple of the lane count, the padding sliced off), the lanes'
        results gathered on the plan's device: a batched :class:`BFSResult`
        for the root layout, a :class:`ShardedRun` in padded global vertex
        order for the vertex-sharded ones."""
        n_lanes, n = len(self._lanes), len(roots)
        roots = roots + [roots[0]] * ((-n) % n_lanes)
        per = len(roots) // n_lanes
        outs = [lane(roots[i * per:(i + 1) * per]) for i, lane in enumerate(self._lanes)]

        def cat(leaves):
            return None if leaves[0] is None else torch.cat(
                [x.to(self.device) for x in leaves])[:n]

        stats = type(outs[0].stats)(*map(cat, zip(*(o.stats for o in outs))))
        res = BFSResult(cat([o.parent for o in outs]), cat([o.level for o in outs]), stats)
        if not self._vertexy:
            return res
        parent, level = res.parent, res.level
        sg = self.graph.sharded
        if sg.partition != "block":
            perm = torch.from_numpy(partition_permutation(
                sg.n_devices, sg.w_loc, sg.partition)).to(self.device).long()
            parent, level = parent[:, perm], level[:, perm]
        return ShardedRun(parent, level, stats.levels, stats.sentinel)

    def bfs(self, roots):
        """Raw traversal(s): a root vector under ``batch_roots`` (leaves
        come back ``[R, ...]``), else one scalar root.  Mesh layouts give a
        batched :class:`BFSResult` (``("root",)``) or a :class:`ShardedRun`
        in padded global vertex order (vertex-sharded layouts)."""
        if not self.plan.batch_roots:
            if self._lanes is None:
                return self._traverse(int(roots))
            out = self._run_lanes([int(roots)])
            return type(out)(*(None if f is None else f[0] for f in out))
        g, p = self.graph, self.plan
        roots = [int(r) for r in np.asarray(roots).reshape(-1)]
        if self._lanes is not None:
            return self._run_lanes(roots)
        if p.kernel == "sssp":
            return _run_sssp_batch(g.chunks, g.degree, roots, delta=self.delta,
                                   max_rounds=self.max_rounds, fault=self.fault)
        return _run_batch(g.chunks, g.degree, self.n_active, roots, self.core,
                          alpha=p.alpha, beta=p.beta, max_levels=p.max_levels,
                          tail=self.tail, fault=self.fault)

    def _strip(self, x: torch.Tensor) -> torch.Tensor:
        """Drop the shard padding of a vertex-sharded result's rows."""
        v = self.num_vertices
        return x if x.shape[-1] == v else x[..., :v]

    @staticmethod
    def _sentinel_of(res):
        """The per-level sentinel trace of one raw result (None for the
        engines without one)."""
        if isinstance(res, ShardedRun):
            return res.sentinel
        return res.stats.sentinel

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _solve(self, roots_np):
        """The raw result of the given roots, batched (per-root plans stack
        their traversals)."""
        if self.plan.batch_roots:
            return self.bfs(roots_np)
        rows = [self.bfs(int(r)) for r in roots_np]
        return (_stack_runs(rows) if isinstance(rows[0], ShardedRun)
                else stack_results(rows))

    def _solve_roots(self, roots_np):
        """Untimed re-solve of the given roots: ``[n, V]`` parent and level
        rows (shard padding stripped) on the plan's device and the per-root
        sentinel trace (None for the engines without one)."""
        res = self._solve(np.asarray(roots_np, np.int64).reshape(-1))
        return (self._strip(res.parent), self._strip(res.level),
                self._sentinel_of(res))

    def _fallback_compiled(self):
        """The degraded recovery plan: the batched single-device bitmap
        traversal of the plan's kernel on the same device, compiled lazily
        and cached; ``None`` when this plan already is that shape or the
        unsharded graph is missing.  The fault rides along: recovery routes
        around a broken exchange, it does not un-break the engine, so a
        fault whose site exists on the degraded path persists."""
        if self._fallback is not None:
            return self._fallback
        p, g = self.plan, self.graph
        if not p.layout and p.engine == "bitmap" and p.batch_roots:
            return None
        if g.ev is None or g.degree is None:
            return None
        fb_plan = TraversalPlan(engine="bitmap", layout=(), batch_roots=True,
                                alpha=p.alpha, beta=p.beta,
                                max_levels=p.max_levels, n_chunks=p.n_chunks,
                                kernel=p.kernel)
        self._fallback = compile_plan(
            fb_plan, PreparedGraph(ev=g.ev, degree=g.degree, core=g.core,
                                   chunks=g.chunks),
            device=self.device, fault=self.fault)
        return self._fallback

    def _recover(self, roots_np, parent, level, failures, check, retries,
                 fallback, on_patch=None) -> tuple[int, int]:
        """Retry, then the degraded fallback, for the rows in ``failures``.

        A re-solved row that passes the checks replaces its row of
        ``parent``/``level`` in place (``on_patch(i, parent_row)`` is told)
        and leaves ``failures``; a row still failing keeps its newest check
        names.  Returns the rows re-solved by retry and by fallback.
        """
        kernel = self.plan.kernel

        def attempt(idx, solver):
            p2, l2, s2 = solver(roots_np[idx])
            f2 = _recheck_rows(self.graph.ev, p2, l2, roots_np[idx], check, s2,
                               kernel=kernel)
            for j, i in enumerate(idx):
                if j in f2:
                    failures[i] = f2[j]
                    continue
                parent[i] = p2[j]
                level[i] = l2[j]
                if on_patch is not None:
                    on_patch(i, p2[j])
                del failures[i]

        n_retried = n_fallback = 0
        for _ in range(max(0, int(retries))):
            if not failures:
                break
            idx = sorted(failures)
            n_retried += len(idx)
            attempt(idx, self._solve_roots)
        if failures and fallback:
            fb = self._fallback_compiled()
            if fb is not None:
                idx = sorted(failures)
                n_fallback += len(idx)
                attempt(idx, fb._solve_roots)
        return n_retried, n_fallback

    def run(self, roots, *, warmup: bool = True, do_validate: bool = True,
            check: Optional[str] = None, retries: int = 0,
            fallback: bool = False) -> Graph500Result:
        """Graph500 steps 3 + 4 under this plan, with checked execution.

        Batched plans time the whole root batch and attribute
        wall-clock / n_roots to each search; per-root plans time each
        search.  The warm-up (``warmup=True``) is one traversal of the first
        root by the plan's kernel and engine, outside the timed region (it
        builds and loads the kernels).

        ``check``: ``"off"`` (no checks, ``all_valid`` reports False),
        ``"post"`` (the kernel's five spec checks on every root, with
        per-check counts) or ``"full"`` (``"post"`` plus the in-loop
        sentinel trace as the ``"sentinel"`` check, for the engines that
        carry one); ``None`` maps ``do_validate`` onto ``"post"`` /
        ``"off"``.  For SSSP the ``level`` rows hold the distances.

        Recovery: roots failing any check are re-solved untimed up to
        ``retries`` times, then (``fallback=True``) on the degraded plan of
        :meth:`_fallback_compiled`.  A recovered root keeps its first time
        and takes the edge count of its new parents.  Roots still failing
        are **quarantined**: TEPS 0.0, so the harmonic mean excludes them,
        and their ids in ``run.quarantined``.  ``run.retries`` /
        ``run.fallbacks`` count the roots re-solved per stage.
        """
        if check is None:
            check = "post" if do_validate else "off"
        if check not in ("off", "post", "full"):
            raise ValueError(f"check must be 'off', 'post' or 'full' (got {check!r})")
        roots_np = np.asarray(roots, np.int64).reshape(-1)
        n = len(roots_np)
        v = self.num_vertices
        g500 = Graph500Run(batched=self.plan.batch_roots)
        if n == 0:
            return Graph500Result(np.zeros((0, v), np.int32),
                                  np.zeros((0, v), np.int32), g500, self.plan,
                                  self.mesh_axes)
        if warmup:
            if self._lanes is None:
                self._traverse(int(roots_np[0]))
            else:
                self._solve(roots_np[:1])
            self._sync()

        if self.plan.batch_roots:
            t0 = time.perf_counter()
            res = self.bfs(roots_np)
            self._sync()
            times = [(time.perf_counter() - t0) / n] * n
        else:
            rows, times = [], []
            for r in roots_np:
                t0 = time.perf_counter()
                row = self.bfs(int(r))
                self._sync()
                times.append(time.perf_counter() - t0)
                rows.append(row)
            res = (_stack_runs(rows) if isinstance(rows[0], ShardedRun)
                   else stack_results(rows))

        degree = self.graph.degree
        # fresh stacks (shard padding stripped): patched in place
        parent, level = self._strip(res.parent), self._strip(res.level)
        edges = traversed_edges(degree, parent).cpu().numpy()
        g500.times_s = [float(dt) for dt in times]
        g500.edges = [int(m) for m in edges]
        g500.teps = [m / dt if dt > 0 else 0.0
                     for m, dt in zip(g500.edges, times)]

        counts, failures = _check_batch(
            self.graph.ev, parent, level, roots_np, check, self._sentinel_of(res),
            kernel=self.plan.kernel)
        g500.check_counts = dict(counts)
        g500.check_failures = {int(roots_np[i]): list(names)
                               for i, names in failures.items()}

        def patched(i, row):
            m = int(traversed_edges(degree, row))
            g500.edges[i] = m
            g500.teps[i] = m / times[i] if times[i] > 0 else 0.0

        g500.retries, g500.fallbacks = self._recover(
            roots_np, parent, level, failures, check, retries, fallback,
            on_patch=patched)
        for i in sorted(failures):
            g500.teps[i] = 0.0      # quarantined: excluded from the hmean
            g500.quarantined.append(int(roots_np[i]))
        if counts:
            g500.validated = [i not in failures for i in range(n)]
        return Graph500Result(parent.cpu().numpy(), level.cpu().numpy(),
                              g500, self.plan, self.mesh_axes)

    def serve_batch(self, roots, *, check: str = "post", retries: int = 0,
                    fallback: bool = False) -> ServeBatch:
        """One checked, untimed root-batch solve: the serving primitive.

        The detect -> retry -> degraded-fallback machinery of :meth:`run`
        without its harness (warm-up, clock, TEPS, quarantine): the serving
        engine owns the clock and the recovery policy, so rows still failing
        come back in ``failures`` for the caller to re-queue.  Rows are in
        batch order and lie on the host when this returns.
        """
        if check not in ("off", "post", "full"):
            raise ValueError(f"check must be 'off', 'post' or 'full' (got {check!r})")
        roots_np = np.asarray(roots, np.int64).reshape(-1)
        if roots_np.size == 0:
            v = self.num_vertices
            return ServeBatch(np.zeros((0, v), np.int32),
                              np.zeros((0, v), np.int32), {}, {})
        parent, level, sent = self._solve_roots(roots_np)
        counts, failures = _check_batch(self.graph.ev, parent, level, roots_np,
                                        check, sent, kernel=self.plan.kernel)
        self._recover(roots_np, parent, level, failures, check, retries, fallback)
        return ServeBatch(parent.cpu().numpy(), level.cpu().numpy(), counts,
                          failures)


def _check_batch(ev, parents, levels, roots, check, sent, kernel="bfs"):
    """Detection pass shared by :meth:`CompiledBFS.run`,
    :meth:`CompiledBFS.serve_batch` and the recovery rechecks.

    Per-check failure counts (zeros included whenever the spec checks ran)
    and a row-index -> failed-check-names map, for any rows and their
    roots.  The checks are the kernel's; ``sent`` is the per-row in-loop
    sentinel trace, applied under ``check="full"`` (None for the engines
    without one)."""
    counts: dict[str, int] = {}
    failures: dict[int, list[str]] = {}
    if check != "off" and ev is not None:
        counts, failures = failure_report(
            validate_result_batch(kernel, ev, parents, levels, roots))
    if check == "full" and sent is not None:
        sent = sent.cpu().numpy()
        bad = np.any((sent != -1) & (sent != SENTINEL_OK), axis=-1)
        counts["sentinel"] = int(np.sum(bad))
        for j in np.nonzero(bad)[0]:
            failures.setdefault(int(j), []).append("sentinel")
    return counts, failures


def _recheck_rows(ev, parents, levels, roots, check, sent, kernel="bfs"):
    """Failure map (row index -> failed check names) of rows re-solved
    during recovery: the same checks as the first pass."""
    return _check_batch(ev, parents, levels, roots, check, sent, kernel=kernel)[1]
