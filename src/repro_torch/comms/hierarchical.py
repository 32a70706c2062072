"""Group-based monitor communication (paper T3, §4.3): the bitmap and min
collectives of the sharded engines, and the psum and all-to-all of
data-parallel training and expert dispatch.

Counterpart of ``repro.comms.hierarchical``.  The paper routes point-to-point traffic through one monitor per router group:
collect inside the group, forward between mirror groups, deliver inside the
group.  Over a ``(group, member)`` mesh that is a two-phase collective: a
reduce-scatter over ``member`` (each member becomes the monitor of 1/M of
the words), an all-reduce over ``group`` (the mirror-group exchange of that
shard), an all-gather over ``member`` (delivery).  Every function keeps the
JAX package's hop structure, because the fault sites act on specific legs:
``inter_group`` on the group leg, ``codec`` on its encoded wire triple.

Each function takes a :class:`~repro_torch.comms.mesh.VertexComm` and a list
of tensors, one per local vertex shard, and returns one per local shard.
Shards whose inputs to a fold are the same tensors get the same result
tensor (it is computed once); a fault that fires on one receiver gives that
receiver its own.  Words are int32 bit-views; distance planes are int64
holding uint32 values, with :data:`INF_U32` the identity of the min.

Float sums keep the JAX package's reduction order: within the group, the
monitors across groups, then delivery, each fold in axis-index order, so
integer-valued inputs give the flat psum bit for bit.  The ``*_spmd``
wrappers take a global tensor whose dim 0 is split over the mesh's vertex
shards and return the global result, as the JAX package's ``shard_map``
wrappers do.
"""
from __future__ import annotations

import torch

from repro_torch.comms.mesh import Mesh, VertexComm, note_collective
from repro_torch.core import faults
from repro_torch.kernels.ref import popcount_u32

#: uint32 +infinity, held in int64: the identity of the min combine.
INF_U32 = 0xFFFFFFFF


def _check_int(x: torch.Tensor, name: str) -> None:
    if x.dtype.is_floating_point or x.dtype.is_complex:
        raise TypeError(f"{name} is for integer/bool payloads, got {x.dtype}")


def _or(ts: list) -> torch.Tensor:
    out = ts[0]
    for t in ts[1:]:
        out = out | t
    return out


def _min(ts: list) -> torch.Tensor:
    out = ts[0]
    for t in ts[1:]:
        out = torch.minimum(out, t)
    return out


def _per_list(peers: list, fn) -> list:
    """``fn`` of each local shard's peer list, computed once per shared list."""
    done: dict = {}
    out = []
    for ps in peers:
        if id(ps) not in done:
            done[id(ps)] = fn(ps)
        out.append(done[id(ps)])
    return out


def _drop(comm, outs, firsts, fault, level, root) -> list:
    if fault is None:
        return outs
    return [faults.drop_peers(fault, o, f, level=level, device=d, root=root)
            for o, f, d in zip(outs, firsts, comm.local)]


def _axis_size(comm: VertexComm, axis: str) -> int:
    return {"member": comm.M, "group": comm.G, "flat": comm.n}[axis]


def _note(kind: str, x: torch.Tensor, group: int, numel: int) -> None:
    """Report a collective over ``group`` shards (none over one) to the
    census (``launch.collective_census``)."""
    if group > 1:
        note_collective(kind, x, group, numel=numel)


def _reduce_scatter(comm: VertexComm, xs: list, fold) -> list:
    """Reduce-scatter over ``member`` (dim 0, tiled): member ``m`` keeps the
    fold of block ``m`` of every member's input.  The census sees the JAX
    package's op: ``reduce-scatter`` for a sum, else the ``all-to-all`` of
    the whole input that its OR / min reduce-scatter is built from."""
    m = comm.M
    lead = xs[0].shape[0]
    assert lead % m == 0, (lead, m)
    if fold is _sum:
        _note("reduce-scatter", xs[0], m, xs[0].numel() // m)
    else:
        _note("all-to-all", xs[0], m, xs[0].numel())
    full = _per_list(comm.gather(xs, "member"),
                     lambda ps: fold([p.reshape(m, lead // m, *p.shape[1:])
                                      for p in ps]))
    return [f[d % m] for f, d in zip(full, comm.local)]


def _all_reduce(comm, xs, axis, fold, *, fault=None, level=None, root=None):
    """All-reduce over ``axis`` (gather, then a local fold).  ``fault``
    (site ``inter_group``) is passed by the inter-group call sites only: when
    it fires, the receiver keeps the axis-index-0 contribution alone.  The
    census sees an ``all-reduce`` for a sum, else the JAX package's
    non-tiled ``all-gather``."""
    n = _axis_size(comm, axis)
    if fold is _sum:
        _note("all-reduce", xs[0], n, xs[0].numel())
    else:
        _note("all-gather", xs[0], n, n * xs[0].numel())
    peers = comm.gather(xs, axis)
    return _drop(comm, _per_list(peers, fold), [ps[0] for ps in peers],
                 fault, level, root)


def _member_all_gather(comm: VertexComm, xs: list) -> list:
    _note("all-gather", xs[0], comm.M, comm.M * xs[0].numel())
    return _per_list(comm.gather(xs, "member"), torch.cat)


def _or_reduce_scatter(comm: VertexComm, xs: list) -> list:
    """Bitwise-OR reduce-scatter over ``member``."""
    return _reduce_scatter(comm, xs, _or)


def _or_all_reduce(comm, xs, axis: str, *, fault=None, level=None, root=None):
    """Bitwise-OR all-reduce over ``axis`` (``member``, ``group`` or
    ``flat``)."""
    return _all_reduce(comm, xs, axis, _or, fault=fault, level=level, root=root)


def hierarchical_por(comm: VertexComm, xs: list, *, fault=None, level=None,
                     root=None) -> list:
    """Lossless bitwise-OR two-phase all-reduce of bitmap words: OR
    reduce-scatter over ``member``, OR all-reduce over ``group``, all-gather
    over ``member``.  A width that ``member`` does not divide ORs within the
    group first, then across (still two phases)."""
    _check_int(xs[0], "hierarchical_por")
    if xs[0].shape[0] % comm.M:
        xs = _or_all_reduce(comm, xs, "member")
        return _or_all_reduce(comm, xs, "group", fault=fault, level=level, root=root)
    shard = _or_reduce_scatter(comm, xs)
    shard = _or_all_reduce(comm, shard, "group", fault=fault, level=level, root=root)
    return _member_all_gather(comm, shard)


def _min_reduce_scatter(comm: VertexComm, xs: list) -> list:
    """Element-wise-min reduce-scatter over ``member``."""
    return _reduce_scatter(comm, xs, _min)


def _min_all_reduce(comm, xs, axis: str, *, fault=None, level=None, root=None):
    """Element-wise-min all-reduce over ``axis``; ``"flat"`` reduces both
    axes in one phase (the ``flat`` wiring)."""
    return _all_reduce(comm, xs, axis, _min, fault=fault, level=level, root=root)


def hierarchical_pmin(comm: VertexComm, xs: list, *, fault=None, level=None,
                      root=None) -> list:
    """Element-wise-min two-phase all-reduce of integer distance planes
    (``hier_min``, the SSSP leg of the monitor exchange): the hop structure
    and the non-dividing fallback of :func:`hierarchical_por`."""
    if xs[0].dtype.is_floating_point or xs[0].dtype == torch.bool:
        raise TypeError(f"hierarchical_pmin is for integer payloads, got {xs[0].dtype}")
    if xs[0].shape[0] % comm.M:
        xs = _min_all_reduce(comm, xs, "member")
        return _min_all_reduce(comm, xs, "group", fault=fault, level=level, root=root)
    shard = _min_reduce_scatter(comm, xs)
    shard = _min_all_reduce(comm, shard, "group", fault=fault, level=level, root=root)
    return _member_all_gather(comm, shard)


# ---------------------------------------------------------------------------
# The density-adaptive wire codec of the inter-group leg.
# ---------------------------------------------------------------------------

def encode_delta(words: torch.Tensor, *, threshold=None):
    """Density-adaptive encode of int32 delta words: ``(mode, payload,
    count)``, 0-d int32 / int32 ``[W]`` / 0-d int32.

    ``mode`` is 1 (sparse) when ``popcount(words) <= threshold``: the first
    ``count`` payload slots then hold the set-bit indices ``word*32 + bit``,
    ascending, the rest zero; else 0 (dense) with the payload the words
    themselves.  ``threshold`` is clamped to ``W`` (None: ``W``), so the
    codec is lossless for every threshold.  Both encodings are computed and
    one is selected on the device, so encoding never synchronises.
    """
    if words.dtype != torch.int32:
        raise TypeError(f"encode_delta is for int32 bit-view words, got {words.dtype}")
    w = words.shape[0]
    thr = w if threshold is None else min(int(threshold), w)
    count = popcount_u32(words).sum().to(torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = ((words[:, None] >> shifts) & 1).reshape(-1).to(torch.bool)
    slot = torch.cumsum(bits, 0) - 1
    target = torch.where(bits & (slot < w), slot, w)
    sparse_payload = torch.zeros(w + 1, dtype=torch.int32, device=words.device)
    sparse_payload.scatter_(0, target, torch.arange(w * 32, dtype=torch.int32,
                                                    device=words.device))
    sparse = count <= thr
    payload = torch.where(sparse, sparse_payload[:w], words)
    return sparse.to(torch.int32), payload, count


def decode_delta(mode: torch.Tensor, payload: torch.Tensor,
                 count: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_delta`, also on corrupted triples as the JAX
    package decodes them: the sparse branch scatter-adds one bit per listed
    index (a negative word index counts from the end, one still outside
    ``[0, W)`` is dropped, and a repeated index carries, as uint32 adds)."""
    w = payload.shape[0]
    valid = torch.arange(w, device=payload.device) < count
    word_i = payload // 32
    word_i = torch.where(word_i < 0, word_i + w, word_i)
    keep = valid & (word_i >= 0) & (word_i < w)
    bit = torch.bitwise_left_shift(torch.ones_like(payload), payload % 32)
    sparse = torch.zeros(w + 1, dtype=torch.int32, device=payload.device)
    sparse.scatter_add_(0, torch.where(keep, word_i, w).long(),
                        torch.where(keep, bit, 0))
    return torch.where(mode == 1, sparse[:w], payload)


def _encoded_or_all_reduce(comm, xs, axis: str = "group", *, threshold=None,
                           fault=None, level=None, root=None) -> list:
    """OR all-reduce over ``axis`` whose contributions cross the wire
    encoded: each shard encodes (``codec`` faults corrupt its triple there),
    the triples are gathered, each receiver decodes and ORs them, and an
    ``inter_group`` fault leaves it the first peer's decode alone."""
    n = _axis_size(comm, axis)
    _note("all-gather", xs[0], n, 2 * n)                  # the (mode, count) headers
    _note("all-gather", xs[0], n, n * xs[0].numel())      # the payloads
    wire = []
    for x, d in zip(xs, comm.local):
        mode, payload, count = encode_delta(x, threshold=threshold)
        if fault is not None:
            mode, payload, count = faults.corrupt_encoded(
                fault, mode, payload, count, level=level, device=d, root=root)
        wire.append(torch.cat([mode.reshape(1), count.reshape(1), payload]))
    peers = comm.gather(wire, axis)
    decoded = _per_list(peers, lambda ps: [decode_delta(p[0], p[2:], p[1]) for p in ps])
    return _drop(comm, [_or(ds) for ds in decoded], [ds[0] for ds in decoded],
                 fault, level, root)


def compressed_hierarchical_por(comm: VertexComm, xs: list, *, known=None,
                                threshold=None, fault=None, level=None,
                                root=None) -> list:
    """:func:`hierarchical_por` with the visited sieve and the
    density-adaptive codec on the inter-group leg.

    ``known`` (a list, one full-width mask per local shard, or None) is the
    destination's last-known visited words: the delta is ANDed against
    ``~known`` before anything crosses the wire.  The result equals
    ``hierarchical_por(xs) & ~known`` whenever the deltas are disjoint from
    ``known``, which the dst-owned BFS engine guarantees.
    """
    _check_int(xs[0], "compressed_hierarchical_por")
    if known is not None:
        xs = [x & ~k for x, k in zip(xs, known)]
    if xs[0].shape[0] % comm.M:
        xs = _or_all_reduce(comm, xs, "member")
        return _encoded_or_all_reduce(comm, xs, "group", threshold=threshold,
                                      fault=fault, level=level, root=root)
    shard = _or_reduce_scatter(comm, xs)
    shard = _encoded_or_all_reduce(comm, shard, "group", threshold=threshold,
                                   fault=fault, level=level, root=root)
    return _member_all_gather(comm, shard)


def hierarchical_all_gather(comm: VertexComm, xs: list) -> list:
    """All-gather over ``member``, then over ``group``: the blocks in
    (group, member) order, as the flat all-gather gives them."""
    blocks = _member_all_gather(comm, xs)
    _note("all-gather", blocks[0], comm.G, comm.G * blocks[0].numel())
    return _per_list(comm.gather(blocks, "group"), torch.cat)


def flat_all_gather(comm: VertexComm, xs: list) -> list:
    """Single-phase all-gather over both axes (the ``flat`` baseline)."""
    _note("all-gather", xs[0], comm.n, comm.n * xs[0].numel())
    return _per_list(comm.gather(xs, "flat"), torch.cat)


# ---------------------------------------------------------------------------
# The psum and all-to-all family: gradient sync and expert dispatch.
# ---------------------------------------------------------------------------

def _sum(ts: list) -> torch.Tensor:
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return out


def hierarchical_psum(comm: VertexComm, xs: list) -> list:
    """Sum over every vertex shard in two phases: reduce-scatter over
    ``member``, psum over ``group`` (each monitor forwards 1/M of the
    bytes), all-gather over ``member``.  A lead dim that ``member`` does not
    divide sums within the group first, then across (still two phases)."""
    if xs[0].shape[0] % comm.M:
        xs = _all_reduce(comm, xs, "member", _sum)
        return _all_reduce(comm, xs, "group", _sum)
    shard = _reduce_scatter(comm, xs, _sum)
    shard = _all_reduce(comm, shard, "group", _sum)
    return _member_all_gather(comm, shard)


def flat_psum(comm: VertexComm, xs: list) -> list:
    """Single-phase sum over both axes (the baseline ``psum``)."""
    return _all_reduce(comm, xs, "flat", _sum)


def compressed_hierarchical_psum(comm: VertexComm, xs: list,
                                 compress_dtype=torch.bfloat16) -> list:
    """:func:`hierarchical_psum` with lossy compression on the inter-group
    leg only: the sum across groups runs in ``compress_dtype``, then returns
    to the input's dtype; within the group the sums stay full precision.
    Integer and boolean payloads never take the cast: they go through the
    exact :func:`hierarchical_psum`."""
    if not xs[0].dtype.is_floating_point:
        return hierarchical_psum(comm, xs)
    orig = xs[0].dtype
    if xs[0].shape[0] % comm.M:
        xs = _all_reduce(comm, xs, "member", _sum)
        out = _all_reduce(comm, [x.to(compress_dtype) for x in xs], "group", _sum)
        return [o.to(orig) for o in out]
    shard = _reduce_scatter(comm, xs, _sum)
    shard = _all_reduce(comm, [s.to(compress_dtype) for s in shard], "group", _sum)
    return _member_all_gather(comm, [s.to(orig) for s in shard])


def hierarchical_all_to_all(comm: VertexComm, xs: list) -> list:
    """Two-phase all-to-all.  Each shard's dim 0 holds ``G * M`` blocks
    ordered destination-major (block ``g_dest * M + m_dest``).  Phase 1
    (within the group): member ``m`` collects every block whose destination
    member is ``m``, the monitor collection.  Phase 2 (mirror groups): the
    monitors exchange across groups.  Shard ``d`` ends with block ``d`` of
    every shard, in source order, as the flat all-to-all delivers it."""
    g_n, m_n = comm.G, comm.M
    lead, rest = xs[0].shape[0], tuple(xs[0].shape[1:])
    assert lead % (g_n * m_n) == 0, (lead, g_n, m_n)
    per = lead // (g_n * m_n)
    _note("all-to-all", xs[0], m_n, xs[0].numel())
    _note("all-to-all", xs[0], g_n, xs[0].numel())
    collected = [torch.stack([p.reshape(g_n, m_n, per, *rest)[:, d % m_n] for p in ps],
                             dim=1)                     # [G_dest, M_src, per, ...]
                 for ps, d in zip(comm.gather(xs, "member"), comm.local)]
    return [torch.stack([q[d // m_n] for q in qs]).reshape(lead, *rest)
            for qs, d in zip(comm.gather(collected, "group"), comm.local)]


def flat_all_to_all(comm: VertexComm, xs: list) -> list:
    """Single-phase all-to-all over both axes (the baseline)."""
    n = comm.n
    lead, rest = xs[0].shape[0], tuple(xs[0].shape[1:])
    assert lead % n == 0, (lead, n)
    _note("all-to-all", xs[0], n, xs[0].numel())
    return [torch.stack([p.reshape(n, lead // n, *rest)[d] for p in ps]).reshape(lead, *rest)
            for ps, d in zip(comm.gather(xs, "flat"), comm.local)]


def _vertex_comm(mesh: Mesh, group_axis: str, member_axis: str) -> VertexComm:
    if (group_axis, member_axis) != ("group", "member") or \
            tuple(mesh.axis_names) != ("group", "member"):
        raise ValueError(f"the spmd collectives run on a ('group', 'member') "
                         f"mesh, got axes {mesh.axis_names} and "
                         f"({group_axis!r}, {member_axis!r})")
    return VertexComm(mesh)


def all_to_all_spmd(mesh: Mesh, group_axis: str = "group",
                    member_axis: str = "member", hierarchical: bool = True):
    """Returns f(x_global) performing the (hierarchical) all-to-all; dim 0
    of ``x_global`` is split over the shards and must factor as P*P*chunk."""
    comm = _vertex_comm(mesh, group_axis, member_axis)
    a2a = hierarchical_all_to_all if hierarchical else flat_all_to_all

    def f(x: torch.Tensor) -> torch.Tensor:
        rows = x.shape[0] // comm.n
        out = a2a(comm, [x[d * rows:(d + 1) * rows] for d in comm.local])
        return torch.cat(comm.all_rows(out))

    return f


def psum_spmd(mesh: Mesh, group_axis: str = "group", member_axis: str = "member",
              hierarchical: bool = True, compress: bool = False):
    """Returns f(x) for x of shape [P, n] (dim 0 split over the shards):
    out[i] = sum_j x[j], the data-parallel gradient synchronisation."""
    comm = _vertex_comm(mesh, group_axis, member_axis)

    def f(x: torch.Tensor) -> torch.Tensor:
        xs = [x[d] for d in comm.local]
        if not hierarchical:
            out = flat_psum(comm, xs)
        elif compress:
            out = compressed_hierarchical_psum(comm, xs)
        else:
            out = hierarchical_psum(comm, xs)
        return torch.stack(comm.all_rows(out))

    return f
