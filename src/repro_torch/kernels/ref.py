"""Plain PyTorch versions of the hand-written kernels (the test oracles).

Bitmaps are carried as ``int32`` tensors holding the uint32 bit patterns of
the JAX package's words (``np.ndarray.view(np.int32)`` at the boundary):
PyTorch's ``uint32`` lacks ``>>``, ``~``, ``+`` and ``min``.  Arithmetic that
needs the unsigned value widens to int64 first (:func:`to_u64`), and a word
computed in int64 comes back with :func:`wrap_i32`, never by an
out-of-range cast.
"""
from __future__ import annotations

import torch

BIG = 2**30
_U32 = 0xFFFFFFFF


def to_u64(w: torch.Tensor) -> torch.Tensor:
    """int32 bit-view words -> int64 holding the unsigned value [0, 2^32)."""
    return w.to(torch.int64) & _U32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> the int32 bit-view of the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def popcount_u32(w: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of each 32-bit word (int32 bit-view in, int32 out)."""
    w = to_u64(w)
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    return ((w * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def ctz_u32(w: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of each 32-bit word; 32 for a zero word."""
    u = to_u64(w)
    low = u & -u  # lowest set bit (0 if u == 0)
    return torch.where(u == 0, torch.full_like(u, 32),
                       popcount_u32(low - 1).to(torch.int64)).to(torch.int32)


def out_aliases(nb: int, p_raw: int, p_vis: int, p_next: int, p_nvis: int,
                p_count: int) -> bool:
    """Whether ``frontier_update``'s outputs (bitmaps of ``nb`` bytes at
    ``p_next``, ``p_nvis``; the 4-byte count at ``p_count``) overlap an input
    bitmap (``p_raw``, ``p_vis``) or each other."""
    return (abs(p_next - p_raw) < nb or abs(p_next - p_vis) < nb
            or abs(p_nvis - p_raw) < nb or abs(p_nvis - p_vis) < nb
            or abs(p_next - p_nvis) < nb
            or p_raw <= p_count < p_raw + nb or p_vis <= p_count < p_vis + nb
            or p_next <= p_count < p_next + nb or p_nvis <= p_count < p_nvis + nb)


def check_frontier_out(next_raw: torch.Tensor, visited: torch.Tensor,
                       out) -> tuple[int, int, int, int, int]:
    """``out=(next, visited, count)`` of ``frontier_update``: contiguous int32
    bitmaps shaped like ``next_raw``, an int32 scalar count, all on its
    device, and no output overlapping an input or another output.  Returns
    the data pointers of (next_raw, visited, next, visited, count).  The BFS
    engine passes ``out`` on every level, so the checks read cheap tensor
    attributes only."""
    if not isinstance(out, (tuple, list)) or len(out) != 3:
        raise ValueError("frontier_update: out must be (next, visited, count)")
    nxt, vis, count = out
    w, dev = next_raw.shape[0], next_raw.get_device()
    i32 = torch.int32
    if (nxt.dtype is not i32 or vis.dtype is not i32 or nxt.dim() != 1 or vis.dim() != 1
            or nxt.shape[0] != w or vis.shape[0] != w or not nxt.is_contiguous()
            or not vis.is_contiguous()):
        raise ValueError(f"frontier_update: out bitmaps must be contiguous int32 "
                         f"{tuple(next_raw.shape)}, got {nxt.dtype} {tuple(nxt.shape)} "
                         f"and {vis.dtype} {tuple(vis.shape)}")
    if count.dtype is not torch.int32 or count.dim() != 0:
        raise ValueError(f"frontier_update: out count must be an int32 scalar, got "
                         f"{count.dtype} {tuple(count.shape)}")
    if nxt.get_device() != dev or vis.get_device() != dev or count.get_device() != dev:
        raise ValueError(f"frontier_update: out on {[str(t.device) for t in out]}, "
                         f"inputs on {next_raw.device}")
    ptrs = (next_raw.data_ptr(), visited.data_ptr(), nxt.data_ptr(), vis.data_ptr(),
            count.data_ptr())
    if out_aliases(4 * w, *ptrs):
        raise ValueError("frontier_update: an output aliases an input or another "
                         "output")
    return ptrs


def frontier_update_ref(next_raw: torch.Tensor, visited: torch.Tensor, out=None):
    """next = next_raw & ~visited; visited |= next; count = popcount(next).

    int32 [W] x2 -> (int32 [W], int32 [W], int32 scalar).  ``out=(next,
    visited, count)`` writes into those buffers and returns them, as the
    kernel's wrapper does.
    """
    if out is not None:
        check_frontier_out(next_raw, visited, out)
    nxt = next_raw & ~visited
    vis = visited | nxt
    count = popcount_u32(nxt).sum().to(torch.int32)
    if out is None:
        return nxt, vis, count
    for dst, src in zip(out, (nxt, vis, count)):
        dst.copy_(src)
    return out


#: Warp steps (32 lanes x 16 bytes) that ``core_spmv``'s kernel reads before
#: it tests them for a hit (``csrc/core_spmv.cu``'s ``kGroupSteps``; the
#: wrapper passes it, and the kernel refuses any other value).
CORE_GROUP_STEPS = 2
#: Words of a core row in one such group.
CORE_GROUP_WORDS = 32 * 4 * CORE_GROUP_STEPS


def core_spmv_ref(a_core: torch.Tensor, frontier_bm: torch.Tensor,
                  words_read=None) -> torch.Tensor:
    """Per core row i: the least column j with A[i, j] & frontier[j], else BIG.

    a_core: int32 [K, W]; frontier_bm: int32 [W]; returns int32 [K].  The
    least column lies in the row's first nonzero word of ``A & frontier``:
    that word's index times 32 plus its trailing zeros.  ``words_read`` (an
    int64 scalar, or None) gains the words the kernel reads
    (:func:`core_words_read`).
    """
    hits = a_core & frontier_bm[None, :]
    nz = hits != 0
    first = nz.to(torch.uint8).argmax(dim=1)    # the first nonzero word (0 if none)
    word = hits.gather(1, first[:, None])[:, 0]
    col = first.to(torch.int32) * 32 + ctz_u32(word)
    out = torch.where(nz.any(dim=1), col, torch.full_like(col, BIG))
    if words_read is not None:
        words_read += core_words_read(out, a_core.shape[1])
    return out


def core_words_read(out: torch.Tensor, w: int) -> torch.Tensor:
    """The words ``core_spmv``'s kernel reads over rows of ``w`` words, from
    its output ``out``: each row up to the end of the group of
    ``CORE_GROUP_WORDS`` that holds its first hit (column ``out[i]``), all
    ``w`` when it has none (``BIG``); an int64 scalar."""
    o = out.to(torch.int64)
    ends = (o // 32 // CORE_GROUP_WORDS + 1) * CORE_GROUP_WORDS
    return torch.where(o < BIG, ends.clamp(max=w), w).sum()


def spmv_mxu_ref(a_core8: torch.Tensor, frontier8: torch.Tensor, *,
                 chunk_rows: int = 4096) -> torch.Tensor:
    """Multi-source Boolean SpMV oracle: int32 [K, R] = A8 [K, K] @ F8 [K, R].

    Computed in float64, which is exact here: |sum| <= K * 128^2 < 2^53.
    torch has no integer matmul on CUDA, and a whole [K, K] float64 copy
    would be 30 GB at K = 61,440, so ``chunk_rows`` rows of A are widened
    at a time.  Callers threshold ``> 0`` for the next-frontier bits.
    """
    k, r = a_core8.shape[0], frontier8.shape[1]
    f = frontier8.to(torch.float64)
    out = torch.empty((k, r), dtype=torch.int32, device=a_core8.device)
    for s in range(0, k, chunk_rows):
        out[s:s + chunk_rows] = (a_core8[s:s + chunk_rows].to(torch.float64) @ f) \
            .to(torch.int32)
    return out


def cin_layer_ref(x0: torch.Tensor, xl: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xDeepFM CIN layer oracle, materialising the outer product.

    x0 [B, F0, D], xl [B, Fl, D], w [H, F0, Fl] -> [B, H, D] with
    out[b, h, d] = sum_ij w[h, i, j] * x0[b, i, d] * xl[b, j, d].  The
    [B, F0, Fl, D] intermediate (82 GB at B = 262,144 and full width) makes
    this a small-batch oracle only.
    """
    outer = torch.einsum("bid,bjd->bijd", x0, xl)
    return torch.einsum("hij,bijd->bhd", w, outer)


def check_relax_inputs(state, changed, front_deg, row_start, dst, weight) -> None:
    """The relax's operands: int64 ``state`` [V], bool ``changed`` [V], int32
    ``front_deg`` [V], int64 ``row_start`` [V], int32 ``dst`` and ``weight``
    (the uint32 weights' bit view, or float32 real weights) of one length,
    contiguous, on one device.  The engine calls this once a round, so the
    passing case reads cheap tensor attributes only."""
    v, dev = state.shape[0] if state.dim() == 1 else -1, state.device
    n_e = dst.shape[0] if dst.dim() == 1 else -1
    for name, t, dtype, n in (("state", state, torch.int64, v),
                              ("changed", changed, torch.bool, v),
                              ("front_deg", front_deg, torch.int32, v),
                              ("row_start", row_start, torch.int64, v),
                              ("dst", dst, torch.int32, n_e),
                              ("weight", weight, (torch.float32 if weight.dtype is torch.float32
                                                   else torch.int32), n_e)):
        if (t.dtype is not dtype or t.dim() != 1 or t.shape[0] != n
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"sssp_relax: {name} must be contiguous {dtype} [{n}] on "
                             f"{dev} (state int64 [V] with V >= 1, dst and weight of one "
                             f"length), got {t.dtype} {tuple(t.shape)} on {t.device}")
    if v < 1:
        raise ValueError("sssp_relax: the state needs at least one vertex")


_SIGN = -2**63   # the top bit of an int64


def real_key_bits(v: int) -> tuple[int, int]:
    """``(parent bits, hop maximum)`` of the real-weight key's low half for
    ``v`` vertices: the parent (``v`` = none) takes the low
    ``v.bit_length()`` bits, the hop count the rest (csrc/sssp_relax.cu)."""
    pbits = int(v).bit_length()
    return pbits, (1 << (32 - pbits)) - 1


def sssp_relax_ref(state, changed, front_deg, row_start, dst, weight) -> None:
    """One round's relax over the frontier's rows, in place.

    ``state`` int64 [V] holds each vertex's uint64 key ``(dist << 32) |
    parent``; ``front_deg`` int32 [V] the frontier vertices' out-degrees (0
    off the frontier); the row of vertex u is ``[row_start[u], row_start[u] +
    degree)`` of ``dst`` and ``weight`` (int32 bit view of uint32 weights).
    Each entry offers ``((dist[u] + w) mod 2^32) << 32 | u`` to its
    destination, with ``dist[u]`` read before the round; the state keeps
    the unsigned minimum and ``changed`` is set where the distance half
    fell.  torch has no uint64 minimum, so the keys are compared as int64
    with the top bit flipped (``key ^ 2^63``), which orders them as
    unsigned: an unflipped key with ``dist >= 2^31`` would read negative.

    With float32 ``weight`` (real weights) the distances are float32 bits
    (non-negative floats order as their bits do), the distance half of a
    candidate is ``fl(dist[u] + w)`` rounded to nearest, and its low half is
    ``hops << pbits | u`` (:func:`real_key_bits`): 0 hops where the add
    raised the distance, else u's own hops plus one (at most the maximum),
    read before the round.  So at one distance the parent fewer such
    entries (a zero weight, or one under half an ulp of the distance) away
    from a strictly nearer vertex wins, hops fall along every parent link,
    and the parents stay a tree.
    """
    check_relax_inputs(state, changed, front_deg, row_start, dst, weight)
    u = torch.nonzero(front_deg > 0).squeeze(1)
    deg = front_deg[u].to(torch.int64)
    src = torch.repeat_interleave(u, deg)
    first = torch.cumsum(deg, 0) - deg
    rows = row_start[src] + torch.arange(src.shape[0], device=src.device) \
        - torch.repeat_interleave(first, deg)
    d = dst[rows].to(torch.int64)
    key = state[src]
    if weight.dtype is torch.float32:
        du = (key >> 32).to(torch.int32)
        nf = du.view(torch.float32) + weight[rows]
        nd = nf.view(torch.int32).to(torch.int64)
        pbits, hmax = real_key_bits(state.shape[0])
        hops = (((key & _U32) >> pbits) + 1).clamp(max=hmax)
        low = torch.where(nd == du, (hops << pbits) | src, src)
    else:
        nd = ((key >> 32) + to_u64(weight[rows])) & _U32
        low = src
    # the flipped candidate (nd - 2^31) * 2^32 + low: exact in int64
    cand = (nd - 2**31) * 2**32 + low
    new = (state ^ _SIGN).scatter_reduce(0, d, cand, "amin", include_self=True) ^ _SIGN
    changed |= ((new >> 32) & _U32) < ((state >> 32) & _U32)
    state.copy_(new)


#: Rows longer than this are walked by a whole warp in the bottom-up relax
#: (csrc/bfs_relax.cu's kWarp): the entries it reads come in such steps.
BFS_WARP = 32


def check_bfs_relax_inputs(frontier_bm, degree, row_start, dst, parent_ext, *,
                           visited_bm=None, core_deg=None, entries_read=None) -> None:
    """The BFS relax's operands: int32 ``degree`` [V] and ``parent_ext``
    [V + 1], int64 ``row_start`` [V], int32 ``dst``, int32 bitmaps of at
    least ceil(V / 32) words, int32 ``core_deg`` of at most V rows, an int64
    scalar ``entries_read``; contiguous, on one device.  The engine calls
    this once a level, so the passing case reads cheap tensor attributes
    only."""
    v = degree.shape[0] if degree.dim() == 1 else -1
    dev = parent_ext.device
    words = (v + 31) // 32
    for name, t, dtype, ok in (
            ("degree", degree, torch.int32, v >= 1),
            ("parent_ext", parent_ext, torch.int32,
             parent_ext.dim() == 1 and parent_ext.shape[0] == v + 1),
            ("row_start", row_start, torch.int64,
             row_start.dim() == 1 and row_start.shape[0] == v),
            ("dst", dst, torch.int32, dst.dim() == 1),
            ("frontier_bm", frontier_bm, torch.int32,
             frontier_bm.dim() == 1 and frontier_bm.shape[0] >= words),
            ("visited_bm", visited_bm, torch.int32,
             visited_bm is None or (visited_bm.dim() == 1 and visited_bm.shape[0] >= words)),
            ("core_deg", core_deg, torch.int32,
             core_deg is None or (core_deg.dim() == 1 and core_deg.shape[0] <= v)),
            ("entries_read", entries_read, torch.int64,
             entries_read is None or entries_read.dim() == 0)):
        if t is None:
            continue
        if t.dtype is not dtype or not ok or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"bfs_relax: {name} must be contiguous {dtype} on {dev} "
                             f"(degree [V] with V >= 1, parent_ext [V + 1], row_start [V], "
                             f"bitmaps of >= ceil(V / 32) words, core_deg of <= V rows, "
                             f"entries_read a scalar), got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def _bits(bm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bit ``idx`` (int64, in range) of the int32 bit-view bitmap ``bm``."""
    return ((to_u64(bm[idx >> 5]) >> (idx & 31)) & 1).to(torch.bool)


def _row_entries(vertices: torch.Tensor, start: torch.Tensor, length: torch.Tensor):
    """(owner's index, position in the row, entry) of every entry of the rows
    ``[start, start + length)`` of ``vertices``, row after row."""
    idx = torch.repeat_interleave(torch.arange(vertices.shape[0], device=vertices.device),
                                  length)
    first = torch.cumsum(length, 0) - length
    pos = torch.arange(idx.shape[0], device=idx.device) - first[idx]
    return idx, pos, start[idx] + pos


def bfs_relax_top_down_ref(frontier_bm, visited_bm, degree, row_start, dst,
                           parent_ext) -> None:
    """A top-down level's relax over the frontier's rows, in place: each
    entry u -> v of a frontier vertex u's row whose v is not visited offers
    u, and ``parent_ext[v]`` keeps the least offer."""
    check_bfs_relax_inputs(frontier_bm, degree, row_start, dst, parent_ext,
                           visited_bm=visited_bm)
    ids = torch.arange(degree.shape[0], device=degree.device)
    u = ids[_bits(frontier_bm, ids) & (degree > 0)]
    idx, _, e = _row_entries(u, row_start[u], degree[u].to(torch.int64))
    v = dst[e].to(torch.int64)
    keep = ~_bits(visited_bm, v)
    parent_ext.scatter_reduce_(0, v[keep], u[idx[keep]].to(torch.int32), "amin")


def bfs_relax_bottom_up_ref(frontier_bm, parent_ext, degree, row_start, dst, core_deg,
                            entries_read=None) -> None:
    """A bottom-up level's relax, in place: each vertex v with
    ``parent_ext[v] == V`` takes the first entry of its row (from
    ``core_deg[v]`` entries in on a core row, v < len(core_deg)) whose
    frontier bit is set; the rows ascend, so that is its least frontier
    neighbour.  ``entries_read`` gains the entries the kernel's walks read:
    up to the hit, or the whole row when none hits, in steps of
    ``BFS_WARP`` on a row longer than that."""
    check_bfs_relax_inputs(frontier_bm, degree, row_start, dst, parent_ext,
                           core_deg=core_deg, entries_read=entries_read)
    n = degree.shape[0]
    start = row_start.clone()
    start[:core_deg.shape[0]] += core_deg
    length = row_start + degree - start
    w = torch.nonzero((parent_ext[:n] == n) & (length > 0)).squeeze(1)
    length = length[w]
    idx, pos, e = _row_entries(w, start[w], length)
    hit = _bits(frontier_bm, dst[e].to(torch.int64))
    first = torch.full_like(length, 2**62).scatter_reduce_(0, idx[hit], pos[hit], "amin")
    found = first < length
    parent_ext[w[found]] = dst[start[w[found]] + first[found]]
    if entries_read is not None:
        step = torch.where(length > BFS_WARP, BFS_WARP, 1)
        reads = torch.where(found, torch.minimum((first // step + 1) * step, length), length)
        entries_read += reads.sum()


# ---------------------------------------------------------------------------
# The bitmap BFS level's bookkeeping (csrc/bfs_level.cuh and its four kernels)
# ---------------------------------------------------------------------------

#: Slots of the level loop's int32 accumulator ``acc``: the frontier's degree
#: sum (m_f) and the visited set's (deg_vis), the graph's entries (nnz), the
#: level delta's degree sum (m_next) and size (popcount of found), and the
#: levels run so far.
ACC_M_F, ACC_DEG_VIS, ACC_NNZ, ACC_M_NEXT, ACC_FOUND, ACC_LEVELS = range(6)
ACC_SLOTS = 6
#: Rows of the level loop's device stats, int32 [STATS_ROWS, max_levels], a
#: column a level: ``direction``, ``scanned_chunks``, ``sentinel`` (-1 where
#: no level ran), ``frontier_size`` and ``scanned_edges`` (0 there).
STATS_DIR, STATS_CH, STATS_OK, STATS_FS, STATS_SE = range(5)
STATS_ROWS = 5


def _check_operands(kernel: str, dev, items) -> None:
    """Each ``(name, tensor, dtype, shape ok, shape wanted)`` of ``items`` is a
    contiguous ``dtype`` tensor on ``dev`` whose shape is ok.  Called once a
    level, so the passing case reads cheap tensor attributes only."""
    for name, t, dtype, ok, want in items:
        if t.dtype is not dtype or not ok or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{kernel}: {name} must be contiguous {dtype} {want} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _stats_ok(stats, lvl: int) -> bool:
    return stats.dim() == 2 and stats.shape[0] == STATS_ROWS and 0 <= lvl < stats.shape[1]


def check_level_delta_operands(parent_ext, visited_bm, degree, level, found, acc) -> None:
    """int32 ``degree`` and ``level`` [V] (V >= 1), ``parent_ext`` [V + 1],
    ``visited_bm`` and ``found`` [W] with W >= ceil(V / 32), ``acc``
    [ACC_SLOTS]."""
    v = degree.shape[0] if degree.dim() == 1 else 0
    w = found.shape[0] if found.dim() == 1 else -1
    i32 = torch.int32
    _check_operands("bfs_level_delta", parent_ext.device, (
        ("degree", degree, i32, v >= 1, "[V], V >= 1"),
        ("parent_ext", parent_ext, i32, parent_ext.shape == (v + 1,), "[V + 1]"),
        ("level", level, i32, level.shape == (v,), "[V]"),
        ("found", found, i32, 32 * w >= v, "[W], W >= ceil(V / 32)"),
        ("visited_bm", visited_bm, i32, visited_bm.shape == (w,), "[W] like found"),
        ("acc", acc, i32, acc.shape == (ACC_SLOTS,), f"[{ACC_SLOTS}]")))


def check_level_stats_operands(next_bm, visited_bm, count, acc, stats, lvl: int,
                               core_rows: int = 0, unvisited=None) -> None:
    """int32 bitmaps ``next_bm`` and ``visited_bm`` of one length, an int32
    scalar ``count``, ``acc`` [ACC_SLOTS], ``stats`` [STATS_ROWS, L] with 0 <= lvl
    < L; ``core_rows`` in [0, 32 W] and ``unvisited`` None or an int32 scalar."""
    i32 = torch.int32
    w = next_bm.shape[0] if next_bm.dim() == 1 else -1
    items = [
        ("next_bm", next_bm, i32, w >= 1, "[W], W >= 1"),
        ("visited_bm", visited_bm, i32, visited_bm.shape == (w,), "[W] like next_bm"),
        ("count", count, i32, count.dim() == 0, "[]"),
        ("acc", acc, i32, acc.shape == (ACC_SLOTS,), f"[{ACC_SLOTS}]"),
        ("stats", stats, i32, _stats_ok(stats, lvl),
         f"[{STATS_ROWS}, L] with L > lvl = {lvl}")]
    if unvisited is not None:
        items.append(("unvisited", unvisited, i32, unvisited.dim() == 0, "[]"))
    _check_operands("bfs_level_stats", next_bm.device, items)
    if not 0 <= core_rows <= 32 * w:
        raise ValueError(f"bfs_level_stats: core_rows must lie in [0, 32 W = {32 * w}], "
                         f"got {core_rows}")


def check_live_chunks_operands(frontier_bm, src_lo, src_hi, stats, lvl: int) -> None:
    """An int32 bitmap ``frontier_bm``, int32 ``src_lo`` and ``src_hi`` of one
    length n >= 1, ``stats`` [STATS_ROWS, L] with 0 <= lvl < L."""
    i32 = torch.int32
    n = src_lo.shape[0] if src_lo.dim() == 1 else 0
    _check_operands("bfs_live_chunks", frontier_bm.device, (
        ("frontier_bm", frontier_bm, i32, frontier_bm.dim() == 1 and frontier_bm.shape[0] >= 1,
         "[W], W >= 1"),
        ("src_lo", src_lo, i32, n >= 1, "[n_chunks], n_chunks >= 1"),
        ("src_hi", src_hi, i32, src_hi.shape == (n,), "[n_chunks] like src_lo"),
        ("stats", stats, i32, _stats_ok(stats, lvl),
         f"[{STATS_ROWS}, L] with L > lvl = {lvl}")))


def check_core_merge_operands(cand, visited_bm, parent_ext) -> None:
    """int32 ``cand`` [K], ``parent_ext`` [V + 1], and an int32 bitmap
    ``visited_bm`` of at least ceil(min(K, V) / 32) words."""
    i32 = torch.int32
    k = cand.shape[0] if cand.dim() == 1 else -1
    v = parent_ext.shape[0] - 1 if parent_ext.dim() == 1 else -1
    _check_operands("bfs_core_merge", parent_ext.device, (
        ("cand", cand, i32, k >= 0, "[K]"),
        ("parent_ext", parent_ext, i32, v >= 0, "[V + 1]"),
        ("visited_bm", visited_bm, i32,
         visited_bm.dim() == 1 and 32 * visited_bm.shape[0] >= min(k, v),
         "[W], W >= ceil(min(K, V) / 32)")))


def bfs_level_delta_ref(parent_ext, visited_bm, degree, level, next_level: int, found,
                        acc) -> None:
    """A level's delta, in place: the vertices v < V with ``parent_ext[v] !=
    V`` whose visited bit is clear are found; ``found`` gets them packed
    (bit i of word j is vertex 32 j + i; every word written), ``level`` gets
    ``next_level`` at each, and ``acc`` the sum of their degrees (modulo
    2^32) at ``ACC_M_NEXT`` and their count at ``ACC_FOUND``."""
    check_level_delta_operands(parent_ext, visited_bm, degree, level, found, acc)
    v, w = degree.shape[0], found.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=found.device)
    seen = (to_u64(visited_bm)[:, None] >> shifts) & 1
    par = torch.full((32 * w,), v, dtype=torch.int32, device=found.device)
    par[:v] = parent_ext[:v]
    newly = (par.view(w, 32) != v) & (seen == 0)
    found.copy_(wrap_i32((newly.to(torch.int64) << shifts).sum(dim=1)))
    newly = newly.reshape(-1)[:v]
    level.masked_fill_(newly, next_level)
    acc[ACC_M_NEXT] = torch.where(newly, degree, 0).sum()
    acc[ACC_FOUND] = popcount_u32(found).sum()


def bfs_level_stats_ref(next_bm, visited_bm, count, acc, stats, lvl: int, bottom_up: bool,
                        in_count: int, n_chunks: int, core_rows: int = 0,
                        unvisited=None) -> None:
    """A level's sentinels and stats, after ``frontier_update`` wrote
    ``next_bm`` and ``count`` from the delta and the old ``visited_bm``:
    ``stats[STATS_DIR, lvl]`` = 1 bottom-up, 0 top-down;
    ``stats[STATS_FS, lvl]`` = ``in_count``, the level's frontier size;
    ``stats[STATS_OK, lvl]`` = (count == the delta's size) + 2 (next and old
    visited disjoint) + 4 (lvl + 1 within the L levels);
    ``stats[STATS_SE, lvl]`` = m_f top-down, nnz - deg_vis bottom-up (int32);
    ``stats[STATS_CH, lvl]`` = ``n_chunks`` bottom-up; then m_f takes the
    delta's degree sum, deg_vis grows by it, and the levels run are lvl + 1.
    With ``unvisited`` (an int32 scalar), the rows i < ``core_rows`` in
    neither ``next_bm`` nor ``visited_bm``, the core rows still unvisited
    after the level, are counted into it."""
    check_level_stats_operands(next_bm, visited_bm, count, acc, stats, lvl, core_rows,
                               unvisited)
    if unvisited is not None:
        rows = torch.arange(core_rows, dtype=torch.int64, device=next_bm.device)
        unvisited.fill_((~_bits(next_bm | visited_bm, rows)).sum())
    s1 = (count == acc[ACC_FOUND]).to(torch.int32)
    s2 = ((next_bm & visited_bm) == 0).all().to(torch.int32)
    stats[STATS_DIR, lvl] = int(bottom_up)
    stats[STATS_FS, lvl] = in_count
    stats[STATS_OK, lvl] = s1 + 2 * s2 + 4 * int(lvl + 1 <= stats.shape[1])
    if bottom_up:
        stats[STATS_SE, lvl] = acc[ACC_NNZ] - acc[ACC_DEG_VIS]
        stats[STATS_CH, lvl] = n_chunks
    else:
        stats[STATS_SE, lvl] = acc[ACC_M_F]
    acc[ACC_DEG_VIS] += acc[ACC_M_NEXT]
    acc[ACC_M_F] = acc[ACC_M_NEXT]
    acc[ACC_LEVELS] = lvl + 1


def chunk_range_mask(src_lo: torch.Tensor, src_hi: torch.Tensor,
                     frontier_bm: torch.Tensor) -> torch.Tensor:
    """bool per chunk: source range ``[src_lo, src_hi]`` meets the frontier.

    Word-granular (conservative superset) test: a chunk is live when any
    bitmap word overlapping its range is nonzero.
    """
    w = frontier_bm.shape[0]
    word_nz = (frontier_bm != 0).to(torch.int32)
    cum = torch.cat([torch.zeros(1, dtype=torch.int32, device=word_nz.device),
                     torch.cumsum(word_nz, 0).to(torch.int32)])
    lo_w = (src_lo // 32).clamp(0, w - 1).long()
    hi_w = (src_hi // 32).clamp(0, w - 1).long()
    nonempty = src_hi >= src_lo
    return nonempty & ((cum[hi_w + 1] - cum[lo_w]) > 0)


def bfs_live_chunks_ref(frontier_bm, src_lo, src_hi, stats, lvl: int) -> None:
    """A top-down level's ``scanned_chunks``: the chunks live in
    ``frontier_bm`` (:func:`chunk_range_mask`), counted into
    ``stats[STATS_CH, lvl]``."""
    check_live_chunks_operands(frontier_bm, src_lo, src_hi, stats, lvl)
    stats[STATS_CH, lvl] = chunk_range_mask(src_lo, src_hi, frontier_bm).sum()


def bfs_core_merge_ref(cand, visited_bm, parent_ext) -> None:
    """The core step's merge, in place: row i < min(K, V) (V =
    ``len(parent_ext) - 1``) takes min(parent_ext[i], cand[i]) when cand[i]
    < BIG and i is not visited (``cand[i]`` lands on vertex i itself, so the
    JAX scatter-min over distinct rows is an elementwise min)."""
    check_core_merge_operands(cand, visited_bm, parent_ext)
    kk = min(cand.shape[0], parent_ext.shape[0] - 1)
    rows = torch.arange(kk, dtype=torch.int64, device=cand.device)
    won = (cand[:kk] < BIG) & ~_bits(visited_bm, rows)
    prefix = parent_ext[:kk]
    prefix.copy_(torch.minimum(prefix, torch.where(won, cand[:kk], parent_ext.shape[0] - 1)))
