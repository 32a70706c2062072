"""δ-stepping SSSP, the second Graph500 kernel, on one device.

Counterpart of the single-device engine of ``repro.core.sssp_steps``.  The
traversal lifecycle is the BFS one with three substitutions:

  * **state carrier** — the changed set and one packed key per vertex,
    ``(dist << 32) | parent`` as the bits of a uint64 in an int64 plane,
    with the JAX package's uint32 distances (``INF_U32`` = unreached) in
    the high half and the parent (``V`` = none) in the low half; the
    round's frontier is *derived*: the changed vertices in the minimum
    δ-bucket.  The JAX engine packs the changed set into a bitmap; a
    ``bool [V]`` carries the same set here.
  * **relax rule** — the JAX engine's two scatter-min passes a round (pass
    A min-relaxes distances over the frontier's out-edges, pass B rebuilds
    the improved vertices' parents as the *minimum source among edges
    achieving the post-relax distance*, so the final parent is a pure
    function of the final distances and bitwise-checkable against
    :func:`sssp_oracle`) become one unsigned minimum of the packed keys
    over the frontier's rows (:func:`repro_torch.kernels.ops.sssp_relax`,
    a hand-written kernel on the card).  Its lexicographic order gives
    both passes' answer: a smaller distance wins with its least source, and
    a tie with a vertex's distance lowers its parent as pass B does.
  * **result contract** — parents keep the BFS conventions and the distance
    plane rides the result's ``level`` slot as int32 (-1 unreached), so the
    plan, runner and validation layers serve both kernels.

Each round pops the whole minimum bucket ``b = min(dist // δ)`` of the
changed set, relaxes all its out-edges (light and heavy together), and
re-enters every improved vertex.  The JAX ``lax.while_loop`` becomes a host
loop with one synchronisation a round, on the size of the changed set; the
batch runs the roots one after another, which gives the rows of the JAX
engine's vmapped batch (whose finished roots stop changing).  The relax
walks the rows of a source-sorted edge view
(:class:`~repro_torch.core.bfs_steps.EdgeRows` with the weight plane, built
once by ``compile_plan``); the vertex-sharded engine keeps the two passes
over its dst-owned edges.
"""
from __future__ import annotations

import heapq
import math

import numpy as np
import torch

from repro_torch.comms import hierarchical as _hier
from repro_torch.core.bfs_steps import EdgeRows
from repro_torch.core.faults import corrupt_parent, fires
from repro_torch.core.heavy import pack_bitmap, testbit
from repro_torch.core.hybrid_bfs import (
    BFSResult, BFSStats, _exchange_delta, _shared, stack_results,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import popcount_u32, real_key_bits
from repro_torch import tracing

#: Exchange wirings of the sharded SSSP engine (:func:`_run_sssp_sharded`).
SSSP_EXCHANGES = ("hier_min", "flat")

#: The unreached distance: the JAX package's uint32 all-ones.
INF_U32 = 0xFFFFFFFF

#: Round bound: δ-stepping takes more rounds than BFS takes levels, so the
#: engine sizes its stats and bound at least this high.
DEFAULT_MAX_ROUNDS = 512


def bucket_width(max_weight: int) -> int:
    """The δ of δ-stepping from the maximum edge weight:
    ``max(1, maxw // 2)``."""
    return max(1, int(max_weight) // 2)


#: The real-weight δ times the mean degree (:func:`real_bucket_width`).  A
#: round costs about 1 ms of passes over V at Graph500 scale 24 on an H100
#: besides its relax, so a wide bucket pays: over δ = 2^-7 .. 1 there
#: (mean degree 58.7) a search fell from 502 to 103 ms as the rounds fell
#: from 395 to 34 and the frontier vertices per reached vertex rose from
#: 1.09 to 7.0; δ = 1/2 (this constant) came within 2% of the fastest with
#: a fifth fewer of them.
REAL_DELTA_DEGREES = 32.0


def real_bucket_width(mean_degree: float) -> float:
    """The δ of δ-stepping for real weights uniform in [0, 1): Meyer and
    Sanders' Θ(1/d) for uniform weights, ``REAL_DELTA_DEGREES`` over the
    mean degree of the vertices with edges, rounded to the nearest power of
    two (at most 1, the weights' bound), so a bucket index
    ``floor(dist / δ)`` is one exact float32 product on every device."""
    ratio = REAL_DELTA_DEGREES / max(float(mean_degree), 1.0)
    return 2.0 ** min(0, round(math.log2(ratio)))


def sssp_max_rounds(max_levels: int) -> int:
    """Engine round bound for a plan's ``max_levels`` (never below the
    δ-stepping default)."""
    return max(int(max_levels), DEFAULT_MAX_ROUNDS)


def _run_sssp_impl(rows: EdgeRows, degree: torch.Tensor, root: int, *,
                   delta, max_rounds: int, fault=None) -> BFSResult:
    """One δ-stepping SSSP from ``root`` over ``rows``.

    ``fault`` (a :class:`~repro_torch.core.faults.FaultSpec`) with the
    ``parent`` site corrupts the improved vertices' parents after the
    relax, by round.

    Real weights (a float32 ``rows.weight``, the specification's reals in
    [0, 1)): ``delta`` is a power of two (:func:`real_bucket_width`)
    and the distance half of the state float32 bits; the relax adds in
    float32, rounded to nearest, and keeps a hop count beside the parent
    (``kernels.ref.sssp_relax_ref``), so the parents stay a tree where
    fl(d + w) == d.  Such a search also fails its last round's bound bit
    (4) of ``stats.sentinel`` when it stopped at ``max_rounds`` with
    vertices still changed, or when a hop count reached its field's
    maximum; the integer search keeps the JAX engine's sentinels.

    While a ``torch.profiler`` session records, the loop puts its work in
    phase ranges ``repro_torch.sssp.<phase>`` (:mod:`repro_torch.tracing`),
    each closed where the next of its depth opens: ``start``, ``sync``
    (blocked on the changed set's size), ``round`` (to the next ``sync``),
    which encloses the round's ``bucket`` (the passes over V that choose the
    frontier), ``relax`` (``ops.sssp_relax`` and the fault site) and
    ``tally`` (the changed set's size and the round's stats), then
    ``finish`` (the sentinels and the result), closed before the empty mark
    ``done``; every range is closed when the search returns or raises.  It
    counts ``sssp.frontier_edges`` (the out-edges of the rounds' frontiers,
    the entries their relax reads), ``sssp.frontier_vertices`` (the rounds'
    frontier sizes summed) and ``sssp.reached_vertices``, each summed on the
    device when :func:`repro_torch.tracing.counters` reads them: the search
    issues no device work for them.
    """
    traced = tracing.recording()
    if traced:
        ph = tracing.Phases("sssp")
        ph.enter("start")
    try:
        v = degree.shape[0]
        dev = degree.device
        i32, i64 = torch.int32, torch.int64
        root = int(root)
        real = rows.weight.dtype is torch.float32
        pbits = real_key_bits(v)[0] if real else 32
        pmask = (1 << pbits) - 1              # the parent's bits of the key

        # (INF_U32 << 32) | V, unreached with no parent, as int64 bits
        state = torch.full((v,), (INF_U32 << 32 | v) - (1 << 64), dtype=i64, device=dev)
        state[root] = root                      # distance 0, its own parent
        changed = torch.zeros(v, dtype=torch.bool, device=dev)
        changed[root] = True
        bs = torch.empty(max_rounds, dtype=i64, device=dev)   # each round's bucket

        stats_b = torch.full((max_rounds,), -1, dtype=i32, device=dev)
        stats_fs = torch.zeros(max_rounds, dtype=i32, device=dev)
        stats_se = torch.zeros(max_rounds, dtype=i32, device=dev)
        stats_ok = torch.full((max_rounds,), -1, dtype=i32, device=dev)

        n_changed, rnd = 1, 0
        while rnd < max_rounds:
            if rnd > 0:
                if traced:
                    ph.enter("sync")
                n_changed = int(n_changed_t)  # the round's one synchronisation
            if n_changed == 0:
                break
            if traced:
                ph.enter("round")
                ph.enter("bucket", 1)
            dist = (state >> 32) & INF_U32
            # The frontier: changed vertices in the minimum bucket.
            if real:   # δ a power of two: the product is exact
                bkt = torch.where(changed,
                                  (dist.to(i32).view(torch.float32) * (1 / delta)).to(i64),
                                  INF_U32)
            else:
                bkt = torch.where(changed, dist // delta, INF_U32)
            b = bkt.min()
            front = changed & (bkt == b)
            front_deg = torch.where(front, degree, 0)
            changed ^= front                     # the frontier leaves the changed set
            if traced:
                ph.enter("relax", 1)
            ops.sssp_relax(state, changed, front_deg, rows.row_start, rows.dst, rows.weight)
            if fires(fault, "parent", level=rnd, root=root):
                improved = ((state >> 32) & INF_U32) < dist
                parent = corrupt_parent(fault, state & pmask, improved,
                                        torch.arange(v, dtype=i64, device=dev), v,
                                        level=rnd, root=root)
                state = (state & ~pmask) | parent
            if traced:
                ph.enter("tally", 1)
            n_changed_t = changed.sum()
            bs[rnd] = b
            stats_fs[rnd] = front.sum()
            stats_se[rnd] = front_deg.sum()
            rnd += 1

        if traced:
            ph.enter("finish")
        if rnd:
            # The rounds' sentinels, from the buckets the loop kept: bucket
            # monotone, frontier nonempty, round within bound (every round ran
            # below it); a healthy round reads 7.
            b = bs[:rnd]
            stats_b[:rnd] = b.clamp(max=0x7FFFFFFF)
            prev = torch.cat([b.new_zeros(1), b[:-1]])
            stats_ok[:rnd] = (b >= prev).to(i32) + 2 * (stats_fs[:rnd] > 0).to(i32) + 4
            if real:
                # a hop count at its maximum, or vertices left changed at the bound
                cut = (state & INF_U32).max() >= (INF_U32 >> pbits) << pbits
                if rnd == max_rounds:
                    cut |= n_changed_t > 0
                stats_ok[rnd - 1] -= 4 * cut.to(i32)
        parent = (state & pmask).to(i32)
        parent = torch.where(parent == v, -1, parent)
        dist = (state >> 32) & INF_U32
        dist_i = torch.where(dist == INF_U32, -1, dist).to(i32)
        result = BFSResult(
            parent=parent, level=dist_i,
            stats=BFSStats(
                stats_b, stats_fs, stats_se,
                torch.tensor(rnd, dtype=i32, device=dev),
                torch.full((max_rounds,), -1, dtype=i32, device=dev),
                torch.tensor(0, dtype=i32, device=dev), stats_ok,
            ),
        )
        if traced:
            # the rounds' entries and frontier sizes and the reached
            # vertices, summed when the counters are read
            tracing.count_later("sssp.frontier_edges", _sum, stats_se[:rnd])
            tracing.count_later("sssp.frontier_vertices", _sum, stats_fs[:rnd])
            tracing.count_later("sssp.reached_vertices", _reached, dist_i)
            ph.close()
            tracing.mark("repro_torch.sssp.done")
        return result
    finally:
        if traced:
            ph.close()


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=torch.int64)


def _reached(dist: torch.Tensor) -> torch.Tensor:
    return (dist >= 0).sum()


def _run_sssp_batch(rows: EdgeRows, degree: torch.Tensor, roots, *,
                    delta, max_rounds: int, fault=None) -> BFSResult:
    """The roots one after another, stacked into ``[R, ...]`` leaves."""
    return stack_results([
        _run_sssp_impl(rows, degree, int(r), delta=delta, max_rounds=max_rounds,
                       fault=fault)
        for r in roots])


def _run_sssp_sharded(shards: list, comm, sg, root: int, *, delta: int,
                      max_rounds: int, exchange: str = "hier_min",
                      fault=None) -> BFSResult:
    """One vertex-sharded δ-stepping SSSP from ``root`` over this process's
    ``shards`` (``hybrid_bfs.shard_inputs``, weighted), with the JAX sharded
    engine's semantics.

    The distance plane and the changed set are replicated (every shard's
    copy; shared tensors while they agree); each shard relaxes its dst-owned
    edges against the round's frontier (pass A distances, pass B parents, as
    on one device) and the round ends in two exchanges: the distance plane by
    element-wise min (``hier_min``: the two-phase
    :func:`~repro_torch.comms.hierarchical.hierarchical_pmin`; ``flat``: one
    phase over both axes) and the changed-set delta bitmap through
    ``_exchange_delta`` (``hier_or_packed``, never the sieve: a vertex
    re-enters the changed set after it was visited; ``flat`` under
    ``flat``).  Sentinels: exchange conservation, replicated-vs-owned
    distance agreement, bucket monotone within the round bound.  Returns the
    padded global parents and distances (``level`` slot, -1 unreached) in
    shard-major order, with the first local shard's stats.
    """
    from repro_torch.core.distributed_bfs import owner_local_of

    if exchange not in SSSP_EXCHANGES:
        raise ValueError(f"unknown SSSP exchange {exchange!r}; expected one of "
                         f"{SSSP_EXCHANGES}")
    n_dev, w_loc = sg.n_devices, sg.w_loc
    v_loc = w_loc * 32
    v_pad = n_dev * v_loc
    w_pad = n_dev * w_loc
    dev = comm.device
    i32, i64 = torch.int32, torch.int64
    root = int(root)
    delta_wire = "flat" if exchange == "flat" else "hier_or_packed"
    r_owner, r_slot = owner_local_of(root, n_dev, w_loc, sg.partition)
    ids_full = torch.arange(v_pad, dtype=i64, device=dev)

    parents = []
    for sh in shards:
        p = torch.full((v_loc,), v_pad, dtype=i32, device=sh.degree.device)
        if sh.d == r_owner:
            p[r_slot] = root
        parents.append(p)
    dist = torch.full((v_pad,), INF_U32, dtype=i64, device=dev)
    dist[root] = 0
    changed = pack_bitmap(ids_full == root, w_pad)
    dists = [dist.to(sh.degree.device) for sh in shards]
    changeds = [changed.to(sh.degree.device) for sh in shards]
    edges = [(sh.src.reshape(-1), sh.dst.reshape(-1).long(), sh.valid.reshape(-1),
              sh.weight.reshape(-1)) for sh in shards]
    prev_b = torch.zeros((), dtype=i64, device=dev)

    stats_b = torch.full((max_rounds,), -1, dtype=i32, device=dev)
    stats_fs = torch.zeros(max_rounds, dtype=i32, device=dev)
    stats_se = torch.zeros(max_rounds, dtype=i32, device=dev)
    stats_ok = torch.full((max_rounds,), -1, dtype=i32, device=dev)

    def bucket(ch, dfull):
        # the round's frontier: the changed vertices in the minimum bucket
        # (replicated work on replicated state)
        is_ch = testbit(ch, ids_full.to(ch.device))
        bkt = torch.where(is_ch, dfull // delta, INF_U32)
        b = bkt.min()
        front = pack_bitmap(is_ch & (bkt == b), w_pad)
        return b, front, ch & ~front

    n_changed, rnd = 1, 0
    n_changed_t = None
    while rnd < max_rounds:
        if rnd > 0:
            n_changed = int(n_changed_t)  # the round's one synchronisation
        if n_changed == 0:
            break
        buckets = _shared(bucket, changeds, dists)

        contribs, deltas, improveds, new_parents, new_locs = [], [], [], [], []
        for sh, (src, dst, valid, wgt), p, dfull, (_, front, _) in zip(
                shards, edges, parents, dists, buckets):
            dist_loc = dfull[sh.gslots]
            # pass A over dst-owned edges: distance scatter-min into owned slots
            active = valid & testbit(front, src)
            cand = torch.where(active, (dfull[src.clamp(max=v_pad - 1)] + wgt) & INF_U32,
                               INF_U32)
            new_loc = dist_loc.scatter_reduce(0, dst, cand, "amin", include_self=True)
            improved = new_loc < dist_loc
            # pass B: parent = min source achieving the post-relax distance
            pbase = torch.where(improved, v_pad, p)
            won = active & (cand == new_loc[dst])
            np_ = pbase.scatter_reduce(0, dst, torch.where(won, src, v_pad), "amin",
                                       include_self=True)
            if fires(fault, "parent", level=rnd, device=sh.d, root=root):
                np_ = corrupt_parent(fault, np_, improved, sh.gslots, v_pad,
                                     level=rnd, device=sh.d, root=root)
            contrib = torch.full((v_pad,), INF_U32, dtype=i64, device=dfull.device)
            contrib[sh.gslots] = new_loc
            contribs.append(contrib)
            deltas.append(pack_bitmap(improved, w_loc))
            new_parents.append(np_)
            new_locs.append(new_loc)

        # exchange 1, the distance plane; exchange 2, the changed-set delta
        if exchange == "flat":
            new_dists = _hier._min_all_reduce(comm, contribs, "flat", fault=fault,
                                              level=rnd, root=root)
        else:
            new_dists = _hier.hierarchical_pmin(comm, contribs, fault=fault,
                                                level=rnd, root=root)
        changed_delta = _exchange_delta(comm, deltas, w_loc=w_loc, n_dev=n_dev,
                                        exchange=delta_wire, partition=sg.partition,
                                        fault=fault, level=rnd, root=root)
        new_changeds = _shared(lambda bk, cd: bk[2] | cd, buckets, changed_delta)
        n_changed_t = popcount_u32(new_changeds[0]).sum()

        sums = [torch.stack([
            popcount_u32(dl).sum(), (nd[sh.gslots] != loc).sum(),
            torch.where(testbit(bk[1], sh.gslots), sh.degree, 0).sum()])
            for sh, dl, nd, loc, bk in zip(shards, deltas, new_dists, new_locs, buckets)]
        delta_sum, mism, scanned = comm.psum(sums).to(i32)
        b, front = buckets[0][0], buckets[0][1]
        s1 = popcount_u32(changed_delta[0]).sum().to(i32) == delta_sum
        s2 = mism == 0
        s3 = (b >= prev_b) & (rnd + 1 <= max_rounds)
        stats_b[rnd] = b.clamp(max=0x7FFFFFFF).to(i32)
        stats_fs[rnd] = popcount_u32(front).sum().to(i32)
        stats_se[rnd] = scanned
        stats_ok[rnd] = s1.to(i32) + 2 * s2.to(i32) + 4 * s3.to(i32)
        parents, dists, changeds, prev_b = new_parents, new_dists, new_changeds, b
        rnd += 1

    parent = torch.cat(comm.all_rows(parents))
    parent = torch.where(parent == v_pad, -1, parent)
    own = [dfull[sh.gslots] for sh, dfull in zip(shards, dists)]
    dist_i = torch.cat(comm.all_rows([torch.where(o == INF_U32, -1, o).to(i32)
                                      for o in own]))
    return BFSResult(
        parent=parent, level=dist_i,
        stats=BFSStats(
            stats_b, stats_fs, stats_se, torch.tensor(rnd, dtype=i32, device=dev),
            torch.full((max_rounds,), -1, dtype=i32, device=dev),
            torch.tensor(0, dtype=i32, device=dev), stats_ok))


# ---------------------------------------------------------------------------
# Host reference oracle (a copy of the JAX package's numpy-only oracle).
# ---------------------------------------------------------------------------

def sssp_oracle(src, dst, valid, weight, num_vertices: int, root: int):
    """Host Dijkstra + deterministic min-source parents.

    Returns ``(parent, dist)`` int32 numpy arrays in the engine's output
    contract: ``dist`` -1 for unreached, ``parent`` -1 for unreached and
    the root's parent itself; for every reached non-root vertex
    ``parent[v] = min{u : dist[u] + w(u, v) == dist[v]}``.
    """
    s = np.asarray(src)
    d = np.asarray(dst)
    va = np.asarray(valid)
    w = np.asarray(weight)
    s = s[va].astype(np.int64)
    d = d[va].astype(np.int64)
    w = w[va].astype(np.int64)

    order = np.argsort(s, kind="stable")
    s2, d2, w2 = s[order], d[order], w[order]
    starts = np.searchsorted(s2, np.arange(num_vertices + 1))

    inf = np.iinfo(np.int64).max
    dist = np.full(num_vertices, inf, np.int64)
    dist[root] = 0
    settled = np.zeros(num_vertices, bool)
    heap = [(0, int(root))]
    while heap:
        du, u = heapq.heappop(heap)
        if settled[u]:
            continue
        settled[u] = True
        for i in range(int(starts[u]), int(starts[u + 1])):
            vtx = int(d2[i])
            nd = du + int(w2[i])
            if nd < dist[vtx]:
                dist[vtx] = nd
                heapq.heappush(heap, (nd, vtx))

    reached_src = dist[s] != inf
    cand = np.where(reached_src, dist[s] + w, inf)
    wins = (cand == dist[d]) & (dist[d] != inf)
    parent = np.full(num_vertices, inf, np.int64)
    np.minimum.at(parent, d[wins], s[wins])
    parent = np.where(dist == inf, -1,
                      np.where(parent == inf, -1, parent))
    parent[root] = root
    dist_out = np.where(dist == inf, -1, dist).astype(np.int32)
    return parent.astype(np.int32), dist_out
