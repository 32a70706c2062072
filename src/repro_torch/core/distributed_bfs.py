"""Host-side partitioner and result helpers of the vertex-sharded engine.

Counterpart of ``repro.core.distributed_bfs``.  The engine itself is
``hybrid_bfs._run_bitmap_sharded`` (and ``sssp_steps._run_sssp_sharded``);
this module holds what it shares with the plan layer and the tests:

  * two word-granular vertex ownership maps (the plan's ``partition``):
    ``"block"`` (shard ``d`` owns words ``[d*W_loc, (d+1)*W_loc)``; after the
    degree sort the heavy prefix lands on shard 0) and ``"word_cyclic"`` (the
    paper's eq. (3) ``owner(v) = v % P`` at uint32-word granularity: shard
    ``d`` owns words ``{w : w % P == d}``, so the heavy words interleave);
  * :func:`shard_graph`, the host partitioner: edges split by destination
    owner (each shard relaxes the edges pointing at its own vertices), kept
    src-sorted and chunked per shard; it runs in numpy and returns torch
    tensors ``[P, ...]`` on the requested device;
  * :func:`partition_permutation` (global order from the shard-major
    concatenation), :func:`shard_edge_skew` and :func:`modeled_wire_bytes`.

The JAX module's deprecated ``make_dist_bfs`` shim is left out, as the port
leaves out every deprecation shim: ``BFSPlan(layout=("group", "member"))``
through ``compile_plan`` is the one entry point.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.bfs_steps import DEFAULT_CHUNKS
from repro_torch.core.heavy import padded_bitmap_words
from repro_torch.util import resolve_device

PARTITIONS = ("block", "word_cyclic")


@dataclass
class ShardedGraph:
    """Dst-owned, per-shard-chunked edge partition (tensors ``[P, ...]``).

    ``num_vertices`` is the padded global count ``P * W_loc * 32``; ids in
    ``[v_orig, num_vertices)`` never appear in edges and stay unvisited.
    Padding lanes carry ``src = num_vertices``, ``dst_local = 0``.
    """

    src: torch.Tensor           # [P, n_chunks, chunk_size] int32 global src ids
    dst_local: torch.Tensor     # [P, n_chunks, chunk_size] int32 owned local slot
    valid: torch.Tensor         # [P, n_chunks, chunk_size] bool
    src_lo: torch.Tensor        # [P, n_chunks] int32 min valid src per chunk
    src_hi: torch.Tensor        # [P, n_chunks] int32 max valid src (-1 empty)
    degree_local: torch.Tensor  # [P, V_loc] int32 degree of owned vertices
    n_active: int               # global non-isolated vertex count
    num_vertices: int           # padded global V (= P * W_loc * 32)
    v_orig: int                 # true vertex count before padding
    n_devices: int
    n_chunks: int
    chunk_size: int
    w_loc: int                  # bitmap words owned per shard
    partition: str = "block"
    # [P, n_chunks, chunk_size] int64 holding the uint32 edge weights (SSSP);
    # None on unweighted shards
    weight: Optional[torch.Tensor] = None


def _check_partition(partition: str) -> None:
    if partition not in PARTITIONS:
        raise ValueError(
            f"unknown partition {partition!r}; expected one of {PARTITIONS}")


def owner_local_of(v, n_devices: int, w_loc: int, partition: str):
    """(owner, local slot) of global vertex ids ``v`` under ``partition``:
    integer arithmetic on numpy arrays, torch tensors or ints.  Block:
    ``owner = v // V_loc``; word-cyclic: ``owner = (v // 32) % P``, local
    word ``(v // 32) // P``."""
    _check_partition(partition)
    v_loc = w_loc * 32
    if partition == "block":
        owner = v // v_loc
        return owner, v - owner * v_loc
    word = v // 32
    return word % n_devices, (word // n_devices) * 32 + v % 32


def partition_permutation(n_devices: int, w_loc: int, partition: str) -> np.ndarray:
    """Gather indices restoring global vertex order from the shard-major
    concatenation of per-shard outputs: ``perm[g] = owner(g) * V_loc +
    local(g)``.  The identity for ``block``."""
    g = np.arange(n_devices * w_loc * 32, dtype=np.int32)
    owner, local = owner_local_of(g, n_devices, w_loc, partition)
    return (owner * (w_loc * 32) + local).astype(np.int32)


def shard_edge_skew(sg: ShardedGraph) -> dict:
    """Per-shard edge-count balance: ``max_over_mean`` is 1.0 for a perfect
    partition and is the padding overhead of the light shards (every shard
    is padded to the heaviest one's edge count)."""
    counts = sg.valid.sum(dim=(1, 2)).cpu().numpy()
    mean = float(counts.mean()) if counts.size else 0.0
    return {
        "per_shard_edges": [int(c) for c in counts],
        "max": int(counts.max()) if counts.size else 0,
        "mean": mean,
        "max_over_mean": float(counts.max() / mean) if mean else 0.0,
    }


def modeled_wire_bytes(level, *, n_devices: int, w_loc: int, group: int,
                       member: int, partition: str = "block") -> dict:
    """Host-side per-level wire-byte model of the ``hier_or``-family delta
    exchange from a completed traversal's ``level`` array (the delta of loop
    step ``t`` is the set of vertices with ``level == t``).

    Per level and per (group, member-block) shard of the two-phase
    collective, three tiers of the inter-group leg (bytes a shard ships to
    its G-1 peer groups, summed over shards): ``raw`` (``4*S_w`` per peer,
    ``S_w`` the member reduce-scatter width, the full width on the
    non-dividing fallback), ``post_sieve`` (``min(raw, 8*nnz_words + 4)``)
    and ``post_codec`` (``min(raw, 4*popcount + 4)``); ``intra.raw`` models
    the member legs.  Returns the JAX package's JSON-ready dict.
    """
    _check_partition(partition)
    g, m = int(group), int(member)
    if g * m != n_devices:
        raise ValueError(f"group*member = {g}*{m} != n_devices {n_devices}")
    level = np.asarray(level).reshape(-1)
    w_pad = n_devices * w_loc
    word_ids = np.arange(w_pad)
    owner = (word_ids % n_devices if partition == "word_cyclic"
             else word_ids // w_loc)
    owner_group = owner // m
    divides = w_pad % m == 0
    sw = w_pad // m if divides else w_pad
    depth = int(level.max()) if level.size else 0
    per_level = []
    totals = {"inter_raw": 0, "inter_post_sieve": 0, "inter_post_codec": 0,
              "intra_raw": 0}
    for t in range(1, depth + 1):
        verts = np.flatnonzero(level == t)
        words = np.zeros(w_pad, np.uint32)
        np.bitwise_or.at(words, verts // 32,
                         np.uint32(1) << (verts % 32).astype(np.uint32))
        raw_blk = 4 * sw
        inter = {"raw": 0, "post_sieve": 0, "post_codec": 0}
        for gi in range(g):
            gwords = np.where(owner_group == gi, words, np.uint32(0))
            for b in range(m):
                blk = gwords[b * sw:(b + 1) * sw] if divides else gwords
                nnz_words = int(np.count_nonzero(blk))
                pop = int(np.unpackbits(blk.view(np.uint8)).sum())
                inter["raw"] += (g - 1) * raw_blk
                inter["post_sieve"] += (g - 1) * min(raw_blk, 8 * nnz_words + 4)
                inter["post_codec"] += (g - 1) * min(raw_blk, 4 * pop + 4)
        intra_dev = 2 * 4 * sw * (m - 1) if divides else 4 * w_pad * (m - 1)
        intra = {"raw": g * m * intra_dev}
        per_level.append({"level": t, "frontier": int(verts.size),
                          "inter": inter, "intra": intra})
        totals["inter_raw"] += inter["raw"]
        totals["inter_post_sieve"] += inter["post_sieve"]
        totals["inter_post_codec"] += inter["post_codec"]
        totals["intra_raw"] += intra["raw"]
    return {
        "partition": partition, "group": g, "member": m, "w_loc": w_loc,
        "scatter_words": sw, "levels": depth,
        "per_level": per_level, "totals": totals,
    }


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def shard_graph(src, dst, valid, num_vertices: int, n_devices: int,
                n_chunks: int = DEFAULT_CHUNKS, partition: str = "block",
                weight=None, device=None) -> ShardedGraph:
    """Host partitioner: word-granular vertex ownership, dst-owner edge
    split, per-shard src-sorted chunks with their source ranges, as the JAX
    package partitions.  ``src/dst/valid`` (and the optional ``weight``
    plane) are the edge view's planes, numpy or torch; the result's tensors
    lie on ``device`` (None: the card)."""
    _check_partition(partition)
    dev = resolve_device(device)
    p = n_devices
    w_base = padded_bitmap_words(num_vertices)
    w_loc = -(-w_base // p)
    v_loc = w_loc * 32
    v_pad = p * v_loc
    src, dst, valid = _numpy(src), _numpy(dst), _numpy(valid).astype(bool)
    weight = None if weight is None else _numpy(weight).astype(np.int64)
    dst_owner, dst_slot = owner_local_of(dst.astype(np.int64), p, w_loc, partition)
    owner = np.where(valid, dst_owner, p)
    counts = np.bincount(owner[valid], minlength=p)[:p]
    e_loc = int(counts.max()) if counts.size else 1
    chunk_size = max(128, -(-e_loc // n_chunks))
    e_pad = n_chunks * chunk_size

    s = np.full((p, e_pad), v_pad, np.int32)
    dl = np.zeros((p, e_pad), np.int32)
    va = np.zeros((p, e_pad), bool)
    wt = None if weight is None else np.zeros((p, e_pad), np.int64)
    for pe in range(p):
        # the (src, dst)-sorted edge order survives the boolean select, so
        # each shard's slice stays src-sorted; padding is a per-shard tail,
        # so the live chunks form a prefix
        sel = valid & (owner == pe)
        k = int(sel.sum())
        s[pe, :k] = src[sel]
        dl[pe, :k] = dst_slot[sel]
        va[pe, :k] = True
        if wt is not None:
            wt[pe, :k] = weight[sel]
    s = s.reshape(p, n_chunks, chunk_size)
    dl = dl.reshape(p, n_chunks, chunk_size)
    va = va.reshape(p, n_chunks, chunk_size)
    src_lo = np.where(va, s, v_pad).min(axis=2).astype(np.int32)
    src_hi = np.where(va, s, -1).max(axis=2).astype(np.int32)

    deg = np.bincount(owner[valid] * v_loc + dst_slot[valid],
                      minlength=p * v_loc).astype(np.int32).reshape(p, v_loc)
    # non-isolated count over BOTH endpoints, as the single-device engines
    # count it (degree > 0)
    ends = np.concatenate([src[valid], dst[valid]])
    n_active = int((np.bincount(ends, minlength=num_vertices) > 0).sum())

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return ShardedGraph(
        src=t(s), dst_local=t(dl), valid=t(va), src_lo=t(src_lo),
        src_hi=t(src_hi), degree_local=t(deg), n_active=n_active,
        num_vertices=v_pad, v_orig=int(num_vertices), n_devices=p,
        n_chunks=n_chunks, chunk_size=chunk_size, w_loc=w_loc,
        partition=partition,
        weight=None if wt is None else t(wt.reshape(p, n_chunks, chunk_size)))


class DistBFSResult(NamedTuple):
    parent: torch.Tensor      # [V_pad] int32 global parent id (-1 unvisited)
    level: torch.Tensor       # [V_pad] int32 (-1 unvisited)
    levels_run: torch.Tensor  # [] int32


def gather_result(res: DistBFSResult, g: ShardedGraph):
    """Global (parent, level) in vertex order, as int64 numpy.  The plan
    runner already restores global order (the word-cyclic permutation at
    traversal exit), so this is a host copy."""
    return (res.parent.cpu().numpy().astype(np.int64),
            res.level.cpu().numpy().astype(np.int64))
