"""Direction-optimizing hybrid BFS (paper §2.1) with selectable engines.

Counterpart of the single-device engines of ``repro.core.hybrid_bfs``,
the Fig. 18 ladder:

  * ``reference`` — edge-parallel relaxation of every edge, both
    directions, over ``bool [V]`` frontier/visited (``_run_legacy``);
  * ``legacy``    — the same state, but bottom-up levels run the
    ``core_spmv`` kernel over the dense core, the frontier re-packed into a
    bitmap every bottom-up level, and the other edges relaxed around it;
  * ``bitmap``    — the bitmap-resident engine (``_run_bitmap_impl``).

Switching policy, paper eq. (1)/(2)::

    top-down  -> bottom-up  when |in| > ThrV1 = (|V| - |vis|) / alpha
    bottom-up -> top-down   when |in| < ThrV2 = |V| / beta

with ``|V|`` the active (non-isolated) vertices.  ``frontier`` and
``visited`` live as packed int32 bit-views ``[W]`` for the whole traversal;
every level ends in the fused ``frontier_update`` kernel, and a bottom-up
level starts with the ``core_spmv`` kernel over the dense heavy core.

JAX's ``lax.while_loop`` becomes a host loop that synchronises once per
level, on the size of the next frontier (the bitmap engine reads it from
its epilogue kernel's popcount); the direction switch is then decided on
the host.  ``lax.cond`` over the edge chunks becomes a gather of the live
chunks (a top-down level also reads their indices back).  The outputs
(parent, level and every stats trace) are bitwise equal to the JAX
engines'.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.bfs_steps import (
    ChunkedEdgeView, EdgeView, chunk_frontier_mask, chunk_range_mask,
    frontier_edge_count, masked_relax_step, relax_step, unvisited_edge_count,
)
from repro_torch.comms import hierarchical as _hier
from repro_torch.core import faults
from repro_torch.core.faults import corrupt_parent, fires
from repro_torch.core.heavy import HeavyCore, pack_bitmap, padded_bitmap_words, testbit
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bitmap_ops import WORDS_PER_TILE
from repro_torch.kernels.ref import BIG, popcount_u32

MAX_LEVELS = 64
TOP_DOWN, BOTTOM_UP = 0, 1

ENGINES = ("reference", "legacy", "bitmap")
#: Exchange wirings of the vertex-sharded engine (:func:`_exchange_delta`).
SHARD_EXCHANGES = ("hier_or", "hier_gather", "flat", "hier_or_packed",
                   "hier_or_sieve")

#: All in-loop sentinel bits passing (BFSStats.sentinel).
SENTINEL_OK = 7


def _switch_direction(direction: int, in_count: int, vis_count: int,
                      n_active: int, alpha: float, beta: float) -> int:
    """Paper eq. (1)/(2) hybrid switch.

    The thresholds divide in float32 and truncate to int32, exactly as the
    JAX engine does: float64 can move a threshold across an integer and
    flip the level at which the direction switches.
    """
    thrv1 = int(np.float32(n_active - vis_count) / np.float32(alpha))
    thrv2 = int(np.float32(n_active) / np.float32(beta))
    if direction == TOP_DOWN and in_count > thrv1:
        return BOTTOM_UP
    if direction == BOTTOM_UP and in_count < thrv2:
        return TOP_DOWN
    return direction


class BFSStats(NamedTuple):
    direction: torch.Tensor       # [MAX_LEVELS] int32 (-1 unused)
    frontier_size: torch.Tensor   # [MAX_LEVELS] int32
    scanned_edges: torch.Tensor   # [MAX_LEVELS] int32 — work estimate per level
    levels: torch.Tensor          # [] int32
    scanned_chunks: torch.Tensor  # [MAX_LEVELS] int32 — edge chunks relaxed (-1 n/a)
    total_chunks: torch.Tensor    # [] int32
    # per-level bitmask, -1 for unused levels: bit0 = delta conservation,
    # bit1 = frontier ∩ visited = ∅, bit2 = level within bound.  None for
    # the reference and legacy engines.
    sentinel: Optional[torch.Tensor] = None


class BFSResult(NamedTuple):
    parent: torch.Tensor  # [V] int32, -1 = unvisited, parent[root] == root
    level: torch.Tensor   # [V] int32, -1 = unvisited
    stats: Optional[BFSStats]


# ---------------------------------------------------------------------------
# Reference and legacy engines: bool [V] frontier state.
# ---------------------------------------------------------------------------

def _core_bottom_up_legacy(core: HeavyCore, frontier, visited, parent_ext,
                           v: int) -> None:
    """Dense-core kernel step with the per-level bool -> bitmap round trip,
    in place.

    The frontier's first K entries are packed (a core padded beyond a tiny
    graph reads False past ``V``), the kernel finds each core row's least
    frontier neighbour, and unvisited rows take it.  Rows at or past ``V``
    count as visited, so only the first ``min(K, V)`` rows can win.
    """
    k = core.k
    f_bm = pack_bitmap(frontier[:k], k // 32)
    cand = kops.core_spmv(core.a_core, f_bm)  # int32 [K]
    kk = min(k, v)
    won = (cand[:kk] < BIG) & ~visited[:kk]
    prefix = parent_ext[:kk]
    prefix.copy_(torch.minimum(prefix, torch.where(won, cand[:kk], v)))


def _run_legacy(ev: EdgeView, degree: torch.Tensor, n_active: int, root: int,
                core: HeavyCore | None, *, engine: str, alpha: float,
                beta: float, max_levels: int) -> BFSResult:
    """One traversal of the ``reference`` or ``legacy`` engine from ``root``
    (host loop, one sync a level).

    Every top-down level (and every level of ``reference``) relaxes all
    padded edges.  A ``legacy`` bottom-up level with a core runs the core
    step, then relaxes every edge but the core-to-core ones.
    """
    v = ev.num_vertices
    dev = degree.device
    i32 = torch.int32
    root = int(root)
    use_core = engine == "legacy" and core is not None

    parent_ext = torch.full((v + 1,), v, dtype=i32, device=dev)
    parent_ext[root] = root
    frontier = torch.zeros(v, dtype=torch.bool, device=dev)
    frontier[root] = True
    visited = frontier.clone()
    level = torch.full((v,), -1, dtype=i32, device=dev)
    level[root] = 0
    tail_mask = ~((ev.src < core.k) & (ev.dst < core.k)) if use_core else None

    stats_dir = torch.full((max_levels,), -1, dtype=i32, device=dev)
    stats_fs = torch.zeros(max_levels, dtype=i32, device=dev)
    stats_se = torch.zeros(max_levels, dtype=i32, device=dev)

    in_count, vis_count = 1, 1
    lvl, direction = 0, TOP_DOWN
    count = None
    while lvl < max_levels:
        if lvl > 0:
            in_count = int(count)  # the level's one synchronisation
            vis_count += in_count
        if in_count == 0:
            break
        direction = _switch_direction(direction, in_count, vis_count,
                                      n_active, alpha, beta)
        if use_core and direction == BOTTOM_UP:
            _core_bottom_up_legacy(core, frontier, visited, parent_ext, v)
            parent_ext, nxt = masked_relax_step(ev, parent_ext, frontier,
                                                visited, tail_mask)
        else:
            parent_ext, nxt = relax_step(ev, parent_ext, frontier, visited)
        # scanned-edge estimate: TD scans the frontier adjacency, BU the
        # unvisited adjacency (the work the direction choice implies).
        stats_se[lvl] = (frontier_edge_count(degree, frontier)
                         if direction == TOP_DOWN
                         else unvisited_edge_count(degree, visited))
        stats_dir[lvl] = direction
        stats_fs[lvl] = in_count
        visited = visited | nxt
        level.masked_fill_(nxt, lvl + 1)
        count = nxt.sum()
        frontier = nxt
        lvl += 1

    parent = parent_ext[:v]
    parent = torch.where(parent == v, -1, parent)
    return BFSResult(
        parent=parent, level=level,
        stats=BFSStats(
            stats_dir, stats_fs, stats_se,
            torch.tensor(lvl, dtype=i32, device=dev),
            torch.full((max_levels,), -1, dtype=i32, device=dev),
            torch.tensor(0, dtype=i32, device=dev),
        ),
    )


# ---------------------------------------------------------------------------
# The bitmap-resident engine.
# ---------------------------------------------------------------------------

def bottom_up_tail(chunks: ChunkedEdgeView, core: HeavyCore | None):
    """(src, dst) of the valid edges a bottom-up level relaxes after the
    core step: every valid edge but the core-to-core ones.

    Compacted once per graph.  The JAX engine masks the same edges in
    place; a scatter-min gives the same parents either way.
    """
    src = chunks.src.reshape(-1)
    dst = chunks.dst.reshape(-1)
    keep = chunks.valid.reshape(-1)
    if core is not None:
        keep = keep & ~((src < core.k) & (dst < core.k))
    return src[keep], dst[keep]


def _core_bottom_up_resident(core: HeavyCore, frontier_bm, visited_bm,
                             parent_ext, v: int) -> None:
    """Dense-core kernel step on the resident frontier bitmap, in place.

    Row i's candidate parent lands on vertex i itself, so the JAX
    scatter-min over distinct rows is an elementwise min on the prefix.
    Rows at or past ``V`` (a core padded beyond a tiny graph) have no edges
    and never win.
    """
    k = core.k
    cand = kops.core_spmv(core.a_core, frontier_bm[: k // 32])  # int32 [K]
    kk = min(k, v)
    rows = torch.arange(kk, dtype=torch.int32, device=cand.device)
    won = (cand[:kk] < BIG) & ~testbit(visited_bm, rows)
    prefix = parent_ext[:kk]
    prefix.copy_(torch.minimum(prefix, torch.where(won, cand[:kk], v)))


def _relax_edges(sc, dc, vc, frontier_bm, visited_bm, parent_ext, v: int) -> None:
    """One edge-parallel relax pass in bitmap space, in place.

    Lanes that are not active scatter the sentinel ``v`` into their own
    destination rather than into the scratch slot ``V``: every parent entry
    is at most ``v``, so the result is the JAX engine's, and the atomics do
    not all pile onto one address.  ``vc`` None means every lane is valid.
    """
    active = testbit(frontier_bm, sc) & ~testbit(visited_bm, dc)
    if vc is not None:
        active &= vc
    cand = torch.where(active, sc, v)
    parent_ext.scatter_reduce_(0, dc.long(), cand, "amin", include_self=True)


def _run_bitmap_impl(chunks: ChunkedEdgeView, degree: torch.Tensor,
                     n_active: int, root: int, core: HeavyCore | None, *,
                     alpha: float, beta: float, max_levels: int,
                     tail, fault=None) -> BFSResult:
    """One bitmap-resident traversal from ``root`` (host loop, one sync a
    level).  ``tail`` is :func:`bottom_up_tail` of the graph; ``fault`` a
    :class:`~repro_torch.core.faults.FaultSpec` whose ``parent`` site
    corrupts the level's epilogue (None: the clean traversal)."""
    v = chunks.num_vertices
    dev = degree.device
    i32 = torch.int32
    w = padded_bitmap_words(v)
    root = int(root)
    tail_src, tail_dst = tail
    nnz_total = degree.sum().to(i32)

    parent_ext = torch.full((v + 1,), v, dtype=i32, device=dev)
    parent_ext[root] = root
    level = torch.full((v,), -1, dtype=i32, device=dev)
    level[root] = 0
    frontier_bm = torch.zeros(w, dtype=i32, device=dev)
    bit = 1 << (root % 32)
    frontier_bm[root // 32] = bit - 2**32 if bit >= 2**31 else bit
    visited_bm = frontier_bm.clone()
    # The epilogue writes each level's (frontier, visited) into the pair the
    # previous level read from, so the loop allocates no bitmaps.
    pairs = [(frontier_bm, visited_bm),
             (torch.empty_like(frontier_bm), torch.empty_like(visited_bm))]
    count = torch.empty((), dtype=i32, device=dev)
    m_f = degree[root].to(i32)
    deg_vis = m_f.clone()

    stats_dir = torch.full((max_levels,), -1, dtype=i32, device=dev)
    stats_fs = torch.zeros(max_levels, dtype=i32, device=dev)
    stats_se = torch.zeros(max_levels, dtype=i32, device=dev)
    stats_ch = torch.full((max_levels,), -1, dtype=i32, device=dev)
    stats_ok = torch.full((max_levels,), -1, dtype=i32, device=dev)

    in_count, vis_count = 1, 1
    lvl, direction = 0, TOP_DOWN
    while lvl < max_levels:
        if lvl > 0:
            in_count = int(count)  # the level's one synchronisation
            vis_count += in_count
        if in_count == 0:
            break
        direction = _switch_direction(direction, in_count, vis_count,
                                      n_active, alpha, beta)
        unvisited = parent_ext[:v] == v
        if direction == BOTTOM_UP:
            if core is not None:
                _core_bottom_up_resident(core, frontier_bm, visited_bm,
                                         parent_ext, v)
            _relax_edges(tail_src, tail_dst, None, frontier_bm, visited_bm,
                         parent_ext, v)
            nsc = chunks.n_chunks  # full scan
        else:
            live = torch.nonzero(chunk_frontier_mask(chunks, frontier_bm)).squeeze(1)
            nsc = int(live.numel())
            _relax_edges(chunks.src[live].reshape(-1),
                         chunks.dst[live].reshape(-1),
                         chunks.valid[live].reshape(-1),
                         frontier_bm, visited_bm, parent_ext, v)

        # Epilogue: pack the newly-found delta, then the fused kernel does
        # mask / merge / popcount in one pass, into the idle pair.
        newly = (parent_ext[:v] != v) & unvisited
        if fires(fault, "parent", level=lvl, root=root):
            # the frontier still comes from the uncorrupted delta
            parent_ext[:v] = corrupt_parent(
                fault, parent_ext[:v], newly,
                torch.arange(v, dtype=i32, device=dev), v, level=lvl, root=root)
        found = pack_bitmap(newly, w)
        next_bm, new_visited_bm = pairs[(lvl + 1) % 2]
        kops.frontier_update(found, visited_bm, out=(next_bm, new_visited_bm, count))

        s1 = count == popcount_u32(found).sum()
        s2 = popcount_u32(next_bm & visited_bm).sum() == 0  # the old visited
        s3 = int(lvl + 1 <= max_levels)
        stats_ok[lvl] = s1.to(i32) + 2 * s2.to(i32) + 4 * s3

        level.masked_fill_(newly, lvl + 1)
        m_next = torch.where(newly, degree, 0).sum().to(i32)
        # scanned-edge estimate: TD scans frontier adjacency (m_f), BU the
        # unvisited adjacency.
        stats_se[lvl] = m_f if direction == TOP_DOWN else nnz_total - deg_vis
        stats_dir[lvl] = direction
        stats_fs[lvl] = in_count
        stats_ch[lvl] = nsc

        frontier_bm, visited_bm = next_bm, new_visited_bm
        m_f, deg_vis = m_next, deg_vis + m_next
        lvl += 1

    parent = parent_ext[:v]
    parent = torch.where(parent == v, -1, parent)
    return BFSResult(
        parent=parent, level=level,
        stats=BFSStats(
            stats_dir, stats_fs, stats_se,
            torch.tensor(lvl, dtype=i32, device=dev), stats_ch,
            torch.tensor(chunks.n_chunks, dtype=i32, device=dev), stats_ok,
        ),
    )


def _run_batch(chunks, degree, n_active, roots, core, **kw) -> BFSResult:
    """The roots one after another through the per-root engine, stacked into
    one batched result ([R, ...] leaves); a ``fault=`` keyword reaches every
    traversal, each with its own root for the fault's root predicate."""
    results = [_run_bitmap_impl(chunks, degree, n_active, int(r), core, **kw)
               for r in roots]
    return stack_results(results)


def stack_results(results: list[BFSResult]) -> BFSResult:
    """Stack per-root results into ``[R, ...]`` leaves; a stats field that
    is None (the legacy engines' sentinel) stays None."""
    stats = BFSStats(*(None if f[0] is None else torch.stack(f)
                       for f in zip(*(r.stats for r in results))))
    return BFSResult(torch.stack([r.parent for r in results]),
                     torch.stack([r.level for r in results]), stats)


# ---------------------------------------------------------------------------
# The vertex-sharded engine (paper T3): resident bitmaps per owned word set,
# one monitor exchange a level.
#
# One traversal spans the vertex shards d = g*M + m of a (group, member)
# mesh.  Each shard holds parent/level/visited of the vertices it owns (the
# partition's word-granular owner map), the edges whose destination it owns
# (src-sorted, chunked), and a replicated frontier bitmap.  A level relaxes
# every shard's owned edges, packs each shard's newly-found delta words and
# combines them into the next frontier through one of the five exchange
# wirings.  JAX runs the shards as devices of one shard_map program; here one
# host loop runs this process's shards in lockstep (every shard of a virtual
# mesh), and each collective takes the list of their tensors.  Each shard
# launches its own kernels, as each device does in JAX.
# ---------------------------------------------------------------------------

class ShardInputs(NamedTuple):
    """One vertex shard's static inputs, on its device."""

    d: int                          # flat vertex-shard index (group-major)
    src: torch.Tensor               # [n_chunks, chunk_size] int32 global src ids
    dst: torch.Tensor               # [n_chunks, chunk_size] int32 owned slots
    valid: torch.Tensor             # [n_chunks, chunk_size] bool
    src_lo: torch.Tensor            # [n_chunks] int32
    src_hi: torch.Tensor            # [n_chunks] int32
    degree: torch.Tensor            # [V_loc] int32
    weight: Optional[torch.Tensor]  # [n_chunks, chunk_size] int64 (SSSP) or None
    tail_src: torch.Tensor          # valid edges a bottom-up level relaxes
    tail_dst: torch.Tensor          # (all but core-to-core), compacted
    n_live: int                     # live chunks (the BU prefix)
    core: Optional[HeavyCore]       # the dense core (None: no core step)
    core_rows: Optional[torch.Tensor]   # int64 core rows this shard owns
    core_slots: Optional[torch.Tensor]  # int64 their local slots
    gslots: torch.Tensor            # [V_loc] int64 global id of each slot


def shard_inputs(sg, d: int, core: HeavyCore | None, device) -> ShardInputs:
    """Vertex shard ``d``'s slices of ``sg`` on ``device``, with its
    bottom-up tail and the core rows it owns (``core`` None: no core step).
    The dense core is not copied: every shard on the core's device reads the
    one tensor."""
    from repro_torch.core.distributed_bfs import owner_local_of

    n_dev, w_loc, part = sg.n_devices, sg.w_loc, sg.partition
    v_loc = w_loc * 32
    t = (lambda a: a[d].to(device))
    src, dst, valid = t(sg.src), t(sg.dst_local), t(sg.valid)
    slots = torch.arange(v_loc, dtype=torch.int64, device=device)
    if part == "word_cyclic":
        gslots = (d + (slots // 32) * n_dev) * 32 + slots % 32
    else:
        gslots = slots + d * v_loc
    tail = valid
    core_rows = core_slots = None
    if core is not None:
        core = dataclasses.replace(core, a_core=core.a_core.to(device))
        dst_global = gslots[dst.long()]
        tail = valid & ~((src < core.k) & (dst_global < core.k))
        rows = torch.arange(core.k, dtype=torch.int64, device=device)
        owner, local = owner_local_of(rows, n_dev, w_loc, part)
        mine = (owner == d) & (local < v_loc)
        core_rows, core_slots = rows[mine], local[mine]
    return ShardInputs(
        d=d, src=src, dst=dst, valid=valid, src_lo=t(sg.src_lo),
        src_hi=t(sg.src_hi), degree=t(sg.degree_local),
        weight=None if sg.weight is None else t(sg.weight),
        tail_src=src[tail], tail_dst=dst[tail],
        n_live=int((sg.src_hi[d] >= 0).sum()),
        core=core, core_rows=core_rows, core_slots=core_slots, gslots=gslots)


def _shared(fn, *lists) -> list:
    """``fn`` of each shard's tensors (one per list), computed once per
    distinct combination of tensors: replicated values are shared tensors,
    so replicated work runs once however many shards there are."""
    done: dict = {}
    out = []
    for args in zip(*lists):
        key = tuple(map(id, args))
        if key not in done:
            done[key] = fn(*args)
        out.append(done[key])
    return out


def _exchange_delta(comm, deltas: list, *, w_loc: int, n_dev: int, exchange: str,
                    partition: str = "block", known=None, fault=None,
                    level=None, root=None) -> list:
    """Combine the shards' delta words into the full next-frontier bitmap,
    one per local shard, through one of the five wirings (all bit-identical
    on clean inputs):

      * ``hier_or`` — scatter the owned words into a zero full-width vector
        and run the two-phase OR (:func:`~repro_torch.comms.hierarchical.
        hierarchical_por`);
      * ``hier_gather`` — two-phase all-gather of the owned blocks;
      * ``flat`` — single-phase all-gather (the baseline);
      * ``hier_or_packed`` — ``hier_or`` with the density-adaptive codec on
        the inter-group leg;
      * ``hier_or_sieve`` — the delta ANDed against ``known`` (each shard's
        replicated visited union) before the codec'd leg.

    Under ``block`` ownership shard ``d``'s local word ``j`` is global word
    ``d*W_loc + j``; under ``word_cyclic`` it is ``d + j*P``, so the owner
    scatter is strided and the gathered shard-major blocks are transposed
    into word order.  Site ``exchange`` corrupts a shard's outgoing words
    here, ``sieve`` its mask; ``codec`` and ``inter_group`` act inside the
    collective.
    """
    if fault is not None:
        deltas = [faults.corrupt_delta(fault, x, level=level, device=d, root=root)
                  for x, d in zip(deltas, comm.local)]
    cyclic = partition == "word_cyclic"
    if exchange in ("hier_or", "hier_or_packed", "hier_or_sieve"):
        fulls = []
        for x, d in zip(deltas, comm.local):
            full = torch.zeros(n_dev * w_loc, dtype=torch.int32, device=x.device)
            if cyclic:
                full.view(w_loc, n_dev)[:, d] = x
            else:
                full[d * w_loc:(d + 1) * w_loc] = x
            fulls.append(full)
        if exchange == "hier_or":
            return _hier.hierarchical_por(comm, fulls, fault=fault, level=level,
                                          root=root)
        kn = known if exchange == "hier_or_sieve" else None
        if kn is not None and fault is not None:
            kn = [faults.corrupt_known(fault, k, level=level, device=d, root=root)
                  for k, d in zip(kn, comm.local)]
        return _hier.compressed_hierarchical_por(comm, fulls, known=kn, fault=fault,
                                                 level=level, root=root)
    if exchange == "hier_gather":
        out = _hier.hierarchical_all_gather(comm, deltas)
    elif exchange == "flat":
        out = _hier.flat_all_gather(comm, deltas)
    else:
        raise ValueError(f"unknown exchange {exchange!r}; expected one of "
                         f"{SHARD_EXCHANGES}")
    if cyclic:
        out = _shared(lambda o: o.view(n_dev, w_loc).t().reshape(-1), out)
    return out


def _relax_owned_edges(sc, dc, vc, frontier_bm, visited_loc, parent, v_pad: int) -> None:
    """Edge-parallel relax of dst-owned edges against the full frontier, in
    place: frontier membership of the global source from the replicated
    bitmap, visited test and scatter-min on the owned slot.  Inactive lanes
    scatter the sentinel into their own slot (a padding lane into slot 0),
    which leaves every entry as it was."""
    active = testbit(frontier_bm, sc) & ~testbit(visited_loc, dc)
    if vc is not None:
        active &= vc
    parent.scatter_reduce_(0, dc.long(), torch.where(active, sc, v_pad), "amin",
                           include_self=True)


def _run_bitmap_sharded(shards: list, comm, sg, root: int, *, alpha: float,
                        beta: float, max_levels: int, exchange: str = "hier_or",
                        fault=None) -> BFSResult:
    """One vertex-sharded bitmap-resident traversal from ``root`` over this
    process's ``shards`` (:func:`shard_inputs`, in ``comm.local`` order;
    their ``core``, when set, runs the core step).

    The sharded sibling of :func:`_run_bitmap_impl` with the JAX engine's
    semantics: the root init, the ``deg_root``/``nnz_total`` sums, the core
    step on the replicated core with the winners applied to owned rows only,
    the chunked top-down, the bottom-up over the live-chunk prefix, the
    ``parent`` fault hook, the exchange, the three in-loop sentinels
    (exchange conservation, owned frontier ∩ visited = ∅, level bound), the
    visited-sieve union and the stats.  The epilogue calls the
    ``frontier_update`` kernel on the owned words exactly when
    ``W_loc % WORDS_PER_TILE == 0`` (the kernel's tile), as JAX does, and ORs
    them otherwise.  Returns the padded global result in shard-major order
    (every shard's rows on every process) with the stats of the first local
    shard (replicated).
    """
    from repro_torch.core.distributed_bfs import owner_local_of

    n_dev, w_loc = sg.n_devices, sg.w_loc
    v_loc = w_loc * 32
    v_pad = n_dev * v_loc
    w_pad = n_dev * w_loc
    dev = comm.device
    i32 = torch.int32
    root = int(root)
    r_owner, r_slot = owner_local_of(root, n_dev, w_loc, sg.partition)

    parents, levels, visited, heads = [], [], [], []
    for sh in shards:
        sdev = sh.degree.device
        p = torch.full((v_loc,), v_pad, dtype=i32, device=sdev)
        lv = torch.full((v_loc,), -1, dtype=i32, device=sdev)
        vis = torch.zeros(w_loc, dtype=i32, device=sdev)
        deg_root = torch.zeros((), dtype=torch.int64, device=sdev)
        if sh.d == r_owner:
            p[r_slot] = root
            lv[r_slot] = 0
            vis[r_slot // 32] = _bit_i32(r_slot % 32)
            deg_root = sh.degree[r_slot].long()
        parents.append(p)
        levels.append(lv)
        visited.append(vis)
        heads.append(torch.stack([deg_root, sh.degree.sum()]))
    frontier = torch.zeros(w_pad, dtype=i32, device=dev)
    frontier[root // 32] = _bit_i32(root % 32)
    frontiers = [frontier.to(sh.degree.device) for sh in shards]
    knowns = frontiers
    head = comm.psum(heads).to(i32)
    deg_root, nnz_total = head[0], head[1]
    m_f, deg_vis = deg_root, deg_root

    stats_dir = torch.full((max_levels,), -1, dtype=i32, device=dev)
    stats_fs = torch.zeros(max_levels, dtype=i32, device=dev)
    stats_se = torch.zeros(max_levels, dtype=i32, device=dev)
    stats_ch = torch.full((max_levels,), -1, dtype=i32, device=dev)
    stats_ok = torch.full((max_levels,), -1, dtype=i32, device=dev)

    in_count, vis_count = 1, 1
    lvl, direction = 0, TOP_DOWN
    in_count_t = None
    while lvl < max_levels:
        if lvl > 0:
            in_count = int(in_count_t)  # the level's one synchronisation
            vis_count += in_count
        if in_count == 0:
            break
        direction = _switch_direction(direction, in_count, vis_count,
                                      sg.n_active, alpha, beta)
        new_parents, newlys, deltas, nscs = [], [], [], []
        for sh, old, fr, vis in zip(shards, parents, frontiers, visited):
            p = old.clone()
            if direction == BOTTOM_UP:
                if sh.core is not None:
                    cand = kops.core_spmv(sh.core.a_core,
                                          fr[: sh.core.k // 32])[sh.core_rows]
                    won = (cand < BIG) & ~testbit(vis, sh.core_slots)
                    p[sh.core_slots] = torch.minimum(p[sh.core_slots],
                                                     torch.where(won, cand, v_pad))
                _relax_owned_edges(sh.tail_src, sh.tail_dst, None, fr, vis, p, v_pad)
                nsc = sh.n_live
            else:
                live = torch.nonzero(chunk_range_mask(sh.src_lo, sh.src_hi, fr)).squeeze(1)
                nsc = int(live.numel())
                _relax_owned_edges(sh.src[live].reshape(-1), sh.dst[live].reshape(-1),
                                   sh.valid[live].reshape(-1), fr, vis, p, v_pad)
            newly = (p != v_pad) & (old == v_pad)
            if fires(fault, "parent", level=lvl, device=sh.d, root=root):
                p = corrupt_parent(fault, p, newly, sh.gslots, v_pad, level=lvl,
                                   device=sh.d, root=root)
            new_parents.append(p)
            newlys.append(newly)
            deltas.append(pack_bitmap(newly, w_loc))
            nscs.append(nsc)

        next_bms = _exchange_delta(comm, deltas, w_loc=w_loc, n_dev=n_dev,
                                   exchange=exchange, partition=sg.partition,
                                   known=knowns, fault=fault, level=lvl, root=root)
        in_count_t = popcount_u32(next_bms[0]).sum()

        sums = []
        for sh, nb, vis, newly, delta, nsc in zip(shards, next_bms, visited, newlys,
                                                 deltas, nscs):
            if sg.partition == "word_cyclic":
                own_next = nb.view(w_loc, n_dev)[:, sh.d]
            else:
                own_next = nb[sh.d * w_loc:(sh.d + 1) * w_loc]
            sums.append(torch.stack([
                popcount_u32(delta).sum(), popcount_u32(own_next & vis).sum(),
                torch.where(newly, sh.degree, 0).sum(),
                torch.tensor(nsc, dtype=torch.int64, device=nb.device)]))
        delta_sum, overlap, m_next, nsc_all = comm.psum(sums).to(i32)
        s1 = in_count_t.to(i32) == delta_sum
        s2 = overlap == 0
        s3 = int(lvl + 1 <= max_levels)
        if w_loc % WORDS_PER_TILE == 0:
            visited = [kops.frontier_update(delta, vis)[1]
                       for delta, vis in zip(deltas, visited)]
        else:
            # owned blocks below the kernel's tile: the plain OR (delta bits
            # are never already visited: owner exactness)
            visited = [vis | delta for delta, vis in zip(deltas, visited)]
        levels = [torch.where(newly, lvl + 1, lv) for newly, lv in zip(newlys, levels)]

        stats_dir[lvl] = direction
        stats_fs[lvl] = in_count
        stats_se[lvl] = m_f if direction == TOP_DOWN else nnz_total - deg_vis
        stats_ch[lvl] = nsc_all
        stats_ok[lvl] = s1.to(i32) + 2 * s2.to(i32) + 4 * s3

        knowns = _shared(torch.bitwise_or, knowns, next_bms)
        parents, frontiers = new_parents, next_bms
        m_f, deg_vis = m_next, deg_vis + m_next
        lvl += 1

    parent = torch.cat(comm.all_rows(parents))
    parent = torch.where(parent == v_pad, -1, parent)
    return BFSResult(
        parent=parent, level=torch.cat(comm.all_rows(levels)),
        stats=BFSStats(
            stats_dir, stats_fs, stats_se, torch.tensor(lvl, dtype=i32, device=dev),
            stats_ch, torch.tensor(sg.n_chunks, dtype=i32, device=dev), stats_ok))


def _bit_i32(b: int) -> int:
    """``1 << b`` as the int32 value of the same bits."""
    return (1 << b) - (1 << 32) if b == 31 else 1 << b
