"""The port's kernels: plain PyTorch versions against the JAX package's
Pallas kernels (interpret mode) on the same numpy inputs.

Bitmaps cross the boundary as uint32 numpy words, viewed as int32 for
torch.  The hand-written CUDA kernels are held against the plain versions
on the card in ``test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ops as jax_ops, ref as jref
from repro.kernels.bitmap_ops import frontier_update as jax_frontier_update
from repro.kernels.frontier_spmv import core_spmv as jax_core_spmv
from repro.kernels.spmv_mxu import spmv_mxu as jax_spmv_mxu
from repro_torch.core import bfs_steps, hybrid_bfs, pipeline
from repro_torch.core.heavy import pack_bitmap, padded_bitmap_words
from repro_torch.core.heavy import testbit as bit_at
from repro_torch.kernels import (bfs_level, bfs_relax, bitmap_ops, cin, frontier_spmv, ops,
                                 ref, spmv_mxu, sssp_relax)

from core_spmv_cases import NO_HIT, first_hit_core, walked_words

torch.set_num_threads(2)


def rand_u32(rng, shape, density=0.5):
    bits = rng.random(shape + (32,)) < density
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little") \
        .view(np.uint32).reshape(shape)


def to_t(words: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32).copy()).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def corner_cases():
    w = 1024
    ones = np.full(w, 0xFFFFFFFF, np.uint32)
    zeros = np.zeros(w, np.uint32)
    bit31 = np.full(w, 0x80000000, np.uint32)
    return [(ones, zeros), (ones, ones), (zeros, ones), (bit31, zeros),
            (ones, bit31), (bit31, bit31)]


# ---------------------------------------------------------------------------
# Plain versions vs the JAX kernels (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_words", [1024, 4096])
@pytest.mark.parametrize("density", [0.01, 0.5])
def test_frontier_update_plain_matches_jax(n_words, density):
    rng = np.random.default_rng(n_words)
    nxt = rand_u32(rng, (n_words,), density)
    vis = rand_u32(rng, (n_words,), density)
    want = jax_frontier_update(jnp.asarray(nxt), jnp.asarray(vis), interpret=True)
    got = ops.frontier_update(to_t(nxt), to_t(vis))
    np.testing.assert_array_equal(to_u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(to_u32(got[1]), np.asarray(want[1]))
    assert got[2].dtype == torch.int32 and int(got[2]) == int(want[2])


@pytest.mark.parametrize("case", range(6))
def test_frontier_update_corners_match_jax(case):
    nxt, vis = corner_cases()[case]
    want = jax_frontier_update(jnp.asarray(nxt), jnp.asarray(vis), interpret=True)
    got = ref.frontier_update_ref(to_t(nxt), to_t(vis))
    np.testing.assert_array_equal(to_u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(to_u32(got[1]), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    if case == 0:
        assert int(got[2]) == 1024 * 32


@pytest.mark.parametrize("density", [0.01, 0.5])
def test_frontier_update_out_matches_jax(density):
    # the engine's form: outputs written into reused caller buffers
    rng = np.random.default_rng(17)
    w = 2048
    out = (torch.full((w,), 7, dtype=torch.int32), torch.full((w,), 7, dtype=torch.int32),
           torch.full((), 7, dtype=torch.int32))
    for _ in range(2):
        nxt, vis = rand_u32(rng, (w,), density), rand_u32(rng, (w,), density)
        want = jax_frontier_update(jnp.asarray(nxt), jnp.asarray(vis), interpret=True)
        got = ops.frontier_update(to_t(nxt), to_t(vis), out=out)
        assert all(g is o for g, o in zip(got, out))
        np.testing.assert_array_equal(to_u32(out[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(to_u32(out[1]), np.asarray(want[1]))
        assert int(out[2]) == int(want[2])


def test_frontier_update_out_refuses_aliases():
    w = 1024
    nxt, vis = torch.zeros(w, dtype=torch.int32), torch.zeros(w, dtype=torch.int32)
    spare = torch.zeros(2 * w + 8, dtype=torch.int32)
    count = torch.zeros((), dtype=torch.int32)
    aliased = [(nxt, spare[:w], count), (spare[:w], vis, count),
               (spare[:w], spare[:w], count), (spare[:w], spare[w:2 * w], spare[w + 3]),
               (spare[1:w + 1], spare[:w], count), (spare[:w], spare[w:2 * w], nxt[5])]
    for out in aliased:
        with pytest.raises(ValueError, match="aliases"):
            ops.frontier_update(nxt, vis, out=out)
    # disjoint views of one buffer are fine
    ops.frontier_update(nxt, vis, out=(spare[:w], spare[w:2 * w], spare[2 * w + 1]))
    for out, match in (((spare[:w],), "out must be"),
                       ((spare[:w], spare[w:2 * w], spare[:1]), "int32 scalar"),
                       ((spare[:w].long(), spare[w:2 * w], count), "int32"),
                       ((spare[:w - 8], spare[w:2 * w], count), "int32")):
        with pytest.raises(ValueError, match=match):
            ops.frontier_update(nxt, vis, out=out)


@pytest.mark.parametrize("nb,ptrs,aliased", [
    (64, (0, 64, 128, 192, 256), False), (64, (0, 64, 128, 191, 256), True),
    (64, (0, 64, 127, 192, 256), True), (64, (0, 64, 128, 192, 255), True),
    (64, (0, 64, 128, 192, 63), True), (64, (0, 0, 128, 192, 256), False)])
def test_out_aliases(nb, ptrs, aliased):
    # (p_raw, p_vis, p_next, p_nvis, p_count); the inputs may share memory
    assert ref.out_aliases(nb, *ptrs) is aliased


@pytest.mark.parametrize("density", [0.001, 0.05])
def test_core_spmv_plain_matches_jax(density):
    rng = np.random.default_rng(4096)
    k = 4096
    a = rand_u32(rng, (k, k // 32), density)
    f = rand_u32(rng, (k // 32,), 0.1)
    want = jax_core_spmv(jnp.asarray(a), jnp.asarray(f), interpret=True)
    got = ops.core_spmv(to_t(a), to_t(f))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _min_neighbour_case():
    k = 4096
    a = np.zeros((k, k // 32), np.uint32)
    for j in (5, 70, 4000):
        a[0, j // 32] |= np.uint32(1) << np.uint32(j % 32)
    f = np.zeros((k // 32,), np.uint32)
    for j in (70, 4000):
        f[j // 32] |= np.uint32(1) << np.uint32(j % 32)
    return a, f


def test_core_spmv_finds_min_neighbor():
    a, f = _min_neighbour_case()
    got = ref.core_spmv_ref(to_t(a), to_t(f))
    want = jax_core_spmv(jnp.asarray(a), jnp.asarray(f), interpret=True)
    assert int(got[0]) == 70 and int(got[1]) == ref.BIG == jref.BIG
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_core_spmv_bit31_column():
    # column 31 of word 0 and column 63 of word 1 sit in the int32 sign bit
    k = 4096
    a = np.zeros((k, k // 32), np.uint32)
    a[0, 0] = 0x80000000
    a[1, 1] = 0x80000001
    f = np.zeros((k // 32,), np.uint32)
    f[0] = 0x80000000
    f[1] = 0x80000000
    got = ref.core_spmv_ref(to_t(a), to_t(f))
    want = np.asarray(jax_core_spmv(jnp.asarray(a), jnp.asarray(f), interpret=True))
    assert int(got[0]) == 31 and int(got[1]) == 63
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", [1000, 1024, 2048])
def test_core_spmv_plain_counts_the_group_walk(w):
    # the plain version's count of words read is the kernel's walk: each row
    # up to the end of the group of its first hit, all of it with none
    # (1,000 words end in a short group; 1,024 and 2,048 in whole ones)
    rng = np.random.default_rng(w)
    a, f, pos = first_hit_core(rng, 512, w)
    words = torch.zeros((), dtype=torch.int64)
    got = ops.core_spmv(to_t(a), to_t(f), words_read=words)
    hit = pos != NO_HIT
    np.testing.assert_array_equal(got.numpy()[hit] // 32, pos[hit])
    assert (got.numpy()[~hit] == ref.BIG).all()
    np.testing.assert_array_equal(got.numpy(), ref.core_spmv_ref(to_t(a), to_t(f)).numpy())
    assert int(words) == walked_words(a, f) < 512 * w
    ops.core_spmv(to_t(a), to_t(f), words_read=words)
    assert int(words) == 2 * walked_words(a, f)


def test_popcount_ctz_match_jax():
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.integers(0, 2**32, size=1000, dtype=np.uint32),
                        np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF],
                                 np.uint32)])
    np.testing.assert_array_equal(ref.popcount_u32(to_t(w)).numpy(),
                                  np.asarray(jref.popcount_u32(jnp.asarray(w))))
    ctz = ref.ctz_u32(to_t(w)).numpy()
    np.testing.assert_array_equal(ctz, np.asarray(jref.ctz_u32(jnp.asarray(w))))
    assert ctz[-5] == 32 and ctz[-3] == 31
    expect = np.array([bin(int(x)).count("1") for x in w])
    np.testing.assert_array_equal(ref.popcount_u32(to_t(w)).numpy(), expect)


def test_cpu_dispatch_never_launches():
    before = ops.launch_counts()
    a, f = _min_neighbour_case()
    ops.core_spmv(to_t(a), to_t(f))
    ops.frontier_update(to_t(a[0]), to_t(a[1]))
    one = torch.ones(1, dtype=torch.int32)
    ops.sssp_relax(torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.bool), one,
                   torch.zeros(1, dtype=torch.int64), one - 1, one)
    args = _bfs_relax_operands()
    ops.bfs_relax_top_down(*args[:-1])
    ops.bfs_relax_bottom_up(args[0], args[5], *args[2:5], args[6])
    _, after, vis, deg, level, found, acc = level_state(64, 0)
    stats = torch.zeros((ref.STATS_ROWS, 4), dtype=torch.int32)
    ops.bfs_level_delta(after, vis, deg, level, 1, found, acc)
    ops.bfs_level_stats(vis, vis, acc[0], acc, stats, 0, True, 5, 1)
    ops.bfs_live_chunks(vis, acc[:1], acc[:1], stats, 0)
    ops.bfs_core_merge(deg, vis, after)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("wrapper", ["frontier_update", "core_spmv"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    # no fallback: the kernel wrapper itself never runs the plain version
    a, f = _min_neighbour_case()
    with pytest.raises(ValueError, match="CUDA tensor"):
        if wrapper == "frontier_update":
            bitmap_ops.frontier_update(to_t(a[0]), to_t(a[1]))
        else:
            frontier_spmv.core_spmv(to_t(a), to_t(f))


# ---------------------------------------------------------------------------
# spmv_mxu and cin_layer: plain versions and CPU dispatch vs the JAX kernels
# ---------------------------------------------------------------------------

def int8_operands(rng, k, r, full_range):
    """A8 [K, K], F8 [K, R]: 0/1 (a Boolean core and frontiers) or every
    int8 value, -128 included."""
    if full_range:
        return (rng.integers(-128, 128, (k, k), dtype=np.int8),
                rng.integers(-128, 128, (k, r), dtype=np.int8))
    return ((rng.random((k, k)) < 0.05).astype(np.int8),
            (rng.random((k, r)) < 0.1).astype(np.int8))


@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("k,r", [(256, 128), (512, 256)])
def test_spmv_mxu_plain_matches_jax(k, r, full_range):
    # integer products: bit-exact
    rng = np.random.default_rng(k * r + full_range)
    a, f = int8_operands(rng, k, r, full_range)
    want = np.asarray(jax_spmv_mxu(jnp.asarray(a), jnp.asarray(f), interpret=True))
    got = ops.multi_source_spmv(torch.from_numpy(a), torch.from_numpy(f))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.spmv_mxu_ref(torch.from_numpy(a), torch.from_numpy(f), chunk_rows=96).numpy(),
        want)
    if full_range:
        assert a.min() == -128 and f.min() == -128


@pytest.mark.parametrize("k,r", [(200, 128), (256, 100), (0, 128)])
def test_spmv_mxu_refuses_untiled_shapes(k, r):
    a = torch.zeros((k, k), dtype=torch.int8)
    f = torch.zeros((k, r), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.multi_source_spmv(a, f)


@pytest.mark.parametrize("k,r,sms", [
    (128, 128, 132), (256, 128, 132), (384, 128, 132), (1024, 256, 132),
    (4224, 128, 132), (4224, 256, 132), (61440, 128, 132), (61440, 256, 132),
    (61440, 128, 114), (3968, 384, 7), (640, 128, 1), (2048, 128, 1000)])
def test_spmv_plan_covers_every_unit_once(k, r, sms):
    plan = spmv_mxu.spmv_plan(k, r, sms)
    assert plan.m_tiles == -(-k // 256) and plan.n_tiles == r // 128
    assert plan.k_steps == k // 128 and plan.units == plan.tiles * plan.k_steps
    assert 1 <= plan.blocks <= min(sms, plan.units)
    # the shares tile [0, units) in order; sizes differ by at most one
    starts = [a for a, _ in plan.ranges]
    ends = [b for _, b in plan.ranges]
    assert starts[0] == 0 and ends[-1] == plan.units and starts[1:] == ends[:-1]
    sizes = [b - a for a, b in plan.ranges]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= spmv_mxu.MIN_UNITS_PER_BLOCK \
        or plan.blocks == 1
    # every (tile, k step) exactly once, and each unit's owner as the kernel
    # computes it
    seen = np.zeros((plan.tiles, plan.k_steps), np.int64)
    for blk, (a, b) in enumerate(plan.ranges):
        for u in (a, b - 1):
            assert spmv_mxu.owner(u, plan.units, plan.blocks) == blk
        for u in range(a, b):
            seen[u // plan.k_steps, u % plan.k_steps] += 1
    assert (seen == 1).all()
    split = {t for t in range(plan.tiles)
             if len({blk for blk, (a, b) in enumerate(plan.ranges)
                     if a < (t + 1) * plan.k_steps and b > t * plan.k_steps}) > 1}
    assert set(plan.split_tiles) == split
    if (k, r, sms) == (61440, 128, 132):
        assert (plan.tiles, plan.k_steps, plan.units, plan.blocks) == (240, 480, 115200, 132)
        assert set(sizes) == {872, 873} and len(plan.split_tiles) == 120
    if (k, r) == (128, 128):
        assert plan.blocks == 1 and plan.split_tiles == ()


def test_spmv_plan_refuses_untiled_shapes():
    for k, r in ((200, 128), (256, 100), (0, 128)):
        with pytest.raises(ValueError, match="multiples of 128"):
            spmv_mxu.spmv_plan(k, r)


def cin_operands(rng, b, f0, fl, h, d):
    """x0, xl ~ N(0, 1) and w at the model's init scale sqrt(1 / (F0 Fl))."""
    return (rng.normal(size=(b, f0, d)).astype(np.float32),
            rng.normal(size=(b, fl, d)).astype(np.float32),
            (rng.normal(size=(h, f0, fl)) * np.sqrt(1.0 / (f0 * fl))).astype(np.float32))


@pytest.mark.parametrize("b,f0,fl,h,d", [
    (128, 8, 8, 16, 4), (256, 12, 20, 8, 10), (128, 39, 16, 8, 10),
    (64, 39, 200, 200, 10)])
def test_cin_layer_plain_matches_jax(b, f0, fl, h, d):
    # fp32 sums in another order than XLA's: rtol = atol = 2e-4, the
    # tolerance of the JAX package's own kernel test
    rng = np.random.default_rng(b + f0 + fl)
    x0, xl, w = cin_operands(rng, b, f0, fl, h, d)
    want = np.asarray(jax_ops.cin_layer(jnp.asarray(x0), jnp.asarray(xl), jnp.asarray(w)))
    got = ops.cin_layer(torch.from_numpy(x0), torch.from_numpy(xl), torch.from_numpy(w))
    assert got.shape == (b, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    plain = ref.cin_layer_ref(torch.from_numpy(x0), torch.from_numpy(xl), torch.from_numpy(w))
    np.testing.assert_allclose(plain.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("wrapper", ["spmv_mxu", "cin_layer", "sssp_relax", "bfs_relax",
                                     "bfs_level"])
def test_new_kernel_wrappers_refuse_cpu_tensors(wrapper):
    before = ops.launch_counts()
    args = _bfs_relax_operands()
    _, parent, vis, deg, level, found, acc = level_state(64, 0)
    stats = torch.zeros((ref.STATS_ROWS, 4), dtype=torch.int32)
    calls = {
        "spmv_mxu": [lambda: spmv_mxu.spmv_mxu(torch.zeros((128, 128), dtype=torch.int8),
                                               torch.zeros((128, 128), dtype=torch.int8))],
        "cin_layer": [lambda: cin.cin_layer(torch.zeros((4, 3, 2)), torch.zeros((4, 5, 2)),
                                            torch.zeros((6, 3, 5)))],
        "sssp_relax": [lambda: sssp_relax.sssp_relax(*_relax_operands())],
        "bfs_relax": [lambda: bfs_relax.top_down(*args[:-1]),
                      lambda: bfs_relax.bottom_up(args[0], args[5], *args[2:5], args[6])],
        "bfs_level": [
            lambda: bfs_level.delta(parent, vis, deg, level, 1, found, acc),
            lambda: bfs_level.stats(vis, vis, acc[0], acc, stats, 0, False, 5, 1),
            lambda: bfs_level.live_chunks(vis, acc[:1], acc[:1], stats, 0),
            lambda: bfs_level.core_merge(deg, vis, parent)],
    }[wrapper]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert ops.launch_counts() == before
    assert set(before) == {"frontier_update", "core_spmv", "spmv_mxu", "cin_layer",
                           "sssp_relax", "bfs_relax", "bfs_level_delta", "bfs_level_stats",
                           "bfs_live_chunks", "bfs_core_merge"}


def _relax_operands(**change):
    """Valid ``sssp_relax`` operands on the CPU (3 vertices, 4 entries),
    with the named ones replaced."""
    args = dict(state=torch.zeros(3, dtype=torch.int64), changed=torch.zeros(3, dtype=torch.bool),
                front_deg=torch.tensor([1, 0, 3], dtype=torch.int32),
                row_start=torch.tensor([0, 1, 1]), dst=torch.tensor([1, 0, 1, 2], dtype=torch.int32),
                weight=torch.ones(4, dtype=torch.int32))
    args.update(change)
    return tuple(args.values())


@pytest.mark.parametrize("change,match", [
    (dict(state=torch.zeros(3, dtype=torch.int32)), "state must be contiguous torch.int64"),
    (dict(changed=torch.zeros(4, dtype=torch.bool)), r"changed must be contiguous torch.bool \[3\]"),
    (dict(front_deg=torch.ones(3, dtype=torch.int64)), "front_deg must be contiguous torch.int32"),
    (dict(weight=torch.ones(5, dtype=torch.int32)), r"weight must be contiguous torch.int32 \[4\]"),
    (dict(dst=torch.arange(8, dtype=torch.int32)[::2]), "dst must be contiguous"),
    (dict(state=torch.zeros(0, dtype=torch.int64), changed=torch.zeros(0, dtype=torch.bool),
          front_deg=torch.zeros(0, dtype=torch.int32), row_start=torch.zeros(0, dtype=torch.int64)),
     "at least one vertex"),
])
def test_sssp_relax_refuses_bad_operands(change, match):
    with pytest.raises(ValueError, match=match):
        ops.sssp_relax(*_relax_operands(**change))


# ---------------------------------------------------------------------------
# bfs_relax: the plain versions against the scatter-min over edge lanes
# ---------------------------------------------------------------------------

def _bfs_relax_operands(**change):
    """Valid ``bfs_relax`` operands on the CPU, in the top-down order with
    ``core_deg`` last (3 vertices, rows 0: {1}, 1: {0, 2}, 2: {1}):
    (frontier_bm, visited_bm, degree, row_start, dst, parent_ext,
    core_deg), the named ones replaced."""
    args = dict(frontier_bm=torch.tensor([0b001], dtype=torch.int32),
                visited_bm=torch.tensor([0b001], dtype=torch.int32),
                degree=torch.tensor([1, 2, 1], dtype=torch.int32),
                row_start=torch.tensor([0, 1, 3]),
                dst=torch.tensor([1, 0, 2, 1], dtype=torch.int32),
                parent_ext=torch.tensor([0, 3, 3, 3], dtype=torch.int32),
                core_deg=torch.zeros(0, dtype=torch.int32))
    args.update(change)
    return tuple(args.values())


@pytest.mark.parametrize("change,match", [
    (dict(parent_ext=torch.zeros(3, dtype=torch.int32)), "parent_ext must be contiguous"),
    (dict(degree=torch.ones(3, dtype=torch.int64)), "degree must be contiguous torch.int32"),
    (dict(row_start=torch.tensor([0, 1, 3], dtype=torch.int32)),
     "row_start must be contiguous torch.int64"),
    (dict(frontier_bm=torch.zeros(0, dtype=torch.int32)), "frontier_bm must be contiguous"),
    (dict(visited_bm=torch.zeros(1, dtype=torch.int64)), "visited_bm must be contiguous"),
    (dict(dst=torch.arange(8, dtype=torch.int32)[::2]), "dst must be contiguous"),
    (dict(core_deg=torch.zeros(4, dtype=torch.int32)), "core_deg must be contiguous"),
])
def test_bfs_relax_refuses_bad_operands(change, match):
    args = _bfs_relax_operands(**change)
    with pytest.raises(ValueError, match=match):
        if "core_deg" in change:
            ops.bfs_relax_bottom_up(args[0], args[5], *args[2:5], args[6])
        else:
            ops.bfs_relax_top_down(*args[:-1])


def test_bfs_relax_on_the_smallest_graph():
    # the path 0 - 1 - 2 from key 0: top-down finds 1; bottom-up from
    # frontier {1} finds 2, and reads one entry of 2's row
    f, vis, deg, rs, dst, p, cd = _bfs_relax_operands()
    ops.bfs_relax_top_down(f, vis, deg, rs, dst, p)
    assert p.tolist() == [0, 0, 3, 3]
    read = torch.zeros((), dtype=torch.int64)
    ops.bfs_relax_bottom_up(torch.tensor([0b010], dtype=torch.int32), p, deg, rs, dst, cd,
                            read)
    assert p.tolist() == [0, 0, 1, 3] and int(read) == 1


_RELAX_GRAPHS: dict = {}


def relax_graph(case):
    """(EdgeView, degree, HeavyCore or None, EdgeRows) on the CPU.
    ``kron12``: degree-sorted with a core that spans every vertex (K = V =
    4,096); ``nocore12``: no sort, no core; ``dup11``: every third row's
    entries each twice (rows still ascending) and 37 padding lanes;
    ``v32768``: scale 15 at edge factor 1, so V is a multiple of 32,768 and
    a padding lane's word V // 32 lies past the bitmap, thousands of
    vertices are isolated, and the core (K = 4,096) is smaller than V."""
    if case not in _RELAX_GRAPHS:
        scale, ef, kw = {"kron12": (12, 16, dict(heavy_threshold=16)),
                         "nocore12": (12, 16, dict(degree_sort=False, heavy_threshold=None)),
                         "dup11": (11, 8, dict(heavy_threshold=None)),
                         "v32768": (15, 1, dict(heavy_threshold=8))}[case]
        b = pipeline.build(pipeline.Graph500Config(scale=scale, edge_factor=ef, seed=5,
                                                   device="cpu", **kw))
        ev, degree = b.ev, b.degree
        if case == "dup11":
            n, v = int(degree.sum()), ev.num_vertices
            rep = torch.where(ev.src[:n] % 3 == 0, 2, 1)
            m = int(rep.sum())
            pad = torch.full((37,), v, dtype=torch.int32)
            ev = bfs_steps.EdgeView(torch.cat([ev.src[:n].repeat_interleave(rep), pad]),
                                    torch.cat([ev.dst[:n].repeat_interleave(rep), pad]),
                                    torch.arange(m + 37) < m, v)
            degree = torch.bincount(ev.src[ev.valid].long(), minlength=v).to(torch.int32)
        _RELAX_GRAPHS[case] = (ev, degree, b.core, bfs_steps.edge_rows(ev, degree, b.core))
    return _RELAX_GRAPHS[case]


def scatter_min_level(ev, core, frontier_bm, visited_bm, parent_ext, bottom_up):
    """The relax as the engine had it (the JAX engine's ``_relax_edges``):
    every valid lane (in a bottom-up level all but the core-to-core ones)
    whose source is in the frontier and destination unvisited scatter-mins
    its source into the destination's parent.  A top-down level relaxed the
    live chunks only; the others hold no frontier source."""
    v = ev.num_vertices
    keep = ev.valid
    if bottom_up and core is not None:
        keep = keep & ~((ev.src < core.k) & (ev.dst < core.k))
    active = keep & bit_at(frontier_bm, ev.src) & ~bit_at(visited_bm, ev.dst)
    parent_ext.scatter_reduce_(0, ev.dst.long(), torch.where(active, ev.src, v), "amin")


def walk_rows(rows, degree, frontier, parent_ext):
    """The bottom-up kernel's walk, vertex by vertex: (parents, entries read)."""
    v = degree.shape[0]
    rs, deg, dst = rows.row_start.numpy(), degree.numpy(), rows.dst.numpy()
    core_deg, out, reads = rows.core_deg.numpy(), parent_ext.clone().numpy(), 0
    for x in np.flatnonzero(out[:v] == v):
        s = rs[x] + (core_deg[x] if x < len(core_deg) else 0)
        row = dst[s:rs[x] + deg[x]]
        hits = np.flatnonzero(frontier[row])
        if not len(hits):
            reads += len(row)
            continue
        out[x] = row[hits[0]]
        step = ref.BFS_WARP if len(row) > ref.BFS_WARP else 1
        reads += min(len(row), (hits[0] // step + 1) * step)
    return out, reads


@pytest.mark.parametrize("case", ["kron12", "nocore12", "dup11", "v32768"])
@pytest.mark.parametrize("bottom_up", [False, True])
@pytest.mark.parametrize("density", [0.05, 0.6])
def test_bfs_relax_plain_matches_the_scatter_min(case, bottom_up, density):
    ev, degree, core, rows = relax_graph(case)
    v = ev.num_vertices
    if case == "v32768":
        assert v % 32768 == 0 and v // 32 == padded_bitmap_words(v)
        assert int((degree == 0).sum()) > 1000 and core is not None and core.k < v
    if case == "dup11":
        dup = (ev.src[1:] == ev.src[:-1]) & (ev.dst[1:] == ev.dst[:-1]) & ev.valid[1:]
        assert bool(dup.any())
    rng = np.random.default_rng(int(density * 100) + 7 * bottom_up)
    visited = rng.random(v) < density
    frontier = visited & (rng.random(v) < 0.5)
    parent = torch.from_numpy(np.append(np.where(visited, rng.integers(0, v, v), v), v)
                              .astype(np.int32))
    w = padded_bitmap_words(v)
    f_bm = pack_bitmap(torch.from_numpy(frontier), w)
    vis_bm = pack_bitmap(torch.from_numpy(visited), w)
    before = parent.clone()
    if bottom_up and core is not None:
        hybrid_bfs._core_bottom_up_resident(core, f_bm, vis_bm, parent)
    want, got = parent.clone(), parent.clone()
    scatter_min_level(ev, core if bottom_up else None, f_bm, vis_bm, want, bottom_up)
    if bottom_up:
        read = torch.zeros((), dtype=torch.int64)
        ops.bfs_relax_bottom_up(f_bm, got, degree, rows.row_start, rows.dst, rows.core_deg,
                                read)
        walked, n_read = walk_rows(rows, degree, frontier, parent)
        np.testing.assert_array_equal(got.numpy(), walked)
        assert int(read) == n_read
        assert n_read > 0 or core.k >= v       # with K >= V every entry is the core's
    else:
        ops.bfs_relax_top_down(f_bm, vis_bm, degree, rows.row_start, rows.dst, got)
    assert torch.equal(got, want)
    assert not torch.equal(got, before)      # the level found someone


@pytest.mark.parametrize("kernel", ["bfs", "sssp"])
def test_bfs_rows_refuse_views_out_of_order(kernel):
    # both kernels' rows refuse sources out of order; only the BFS walk,
    # which stops at a row's first frontier neighbour, needs each row to
    # ascend: the SSSP relax reads whole rows and takes them in any order
    ev, degree, core, rows = relax_graph("nocore12")
    assert torch.equal(rows.row_start, torch.cumsum(degree, 0) - degree)
    assert rows.core_deg.numel() == 0 and rows.weight is None
    _, k_degree, core, k_rows = relax_graph("kron12")
    assert core.k == ev.num_vertices and torch.equal(k_rows.core_deg, k_degree)  # K = V
    weighted = kernel == "sssp"
    if weighted:
        ev = bfs_steps.with_edge_weights(ev, seed=3)
    u = int(torch.argmax(degree))
    s = int(torch.cumsum(degree, 0)[u] - degree[u])
    flipped = ev.dst.clone()
    flipped[s:s + 2] = flipped[s:s + 2].flip(0)
    flipped_view = bfs_steps.EdgeView(ev.src, flipped, ev.valid, ev.num_vertices, ev.weight)
    rolled = bfs_steps.EdgeView(ev.src.roll(1), ev.dst.roll(1), ev.valid.roll(1),
                                ev.num_vertices,
                                None if ev.weight is None else ev.weight.roll(1))
    with pytest.raises(ValueError, match="source-sorted") as refused:
        bfs_steps.edge_rows(rolled, degree, weighted=weighted)
    assert ("each row ascending" in str(refused.value)) == (not weighted)
    if weighted:
        got = bfs_steps.edge_rows(flipped_view, degree, weighted=True)
        assert torch.equal(got.dst, flipped)
        assert torch.equal(got.weight, ref.wrap_i32(ev.weight))
    else:
        with pytest.raises(ValueError, match="each row ascending"):
            bfs_steps.edge_rows(flipped_view, degree)


# ---------------------------------------------------------------------------
# cin_layer: the kernel's 3xTF32 arithmetic, emulated, and its launch plan
# ---------------------------------------------------------------------------

def cin_tf32_emulation(x0, xl, w, passes: int = 3) -> torch.Tensor:
    """The CUDA kernel's arithmetic in plain torch: one GEMM over the padded
    K of (i, j) pairs in the kernel's order.  z[n, (i, j)] = x0[b, i, d] *
    xl[b, j, d] rounded to fp32 (n = b * D + d), split as hi = tf32(z),
    lo = tf32(z - hi), against the prep's w_hi / w_lo; the products
    lo*hi + hi*lo + hi*hi (``passes=3``) or hi*hi alone (one TF32 pass)."""
    b, f0, d = x0.shape
    h, _, fl = w.shape
    plan = cin.cin_plan(b, f0, fl, h, d)
    wh, wl = cin.weight_layout(w, plan)                  # [h_pad, k_pad] each
    pairs = torch.einsum("bid,bjd->bdij", x0, xl).reshape(b * d, f0 * fl)
    z = torch.cat([pairs, torch.zeros(b * d, 1)], 1)[:, cin.k_index(f0, fl)]
    zh = cin.tf32_round(z)
    zl = cin.tf32_round(z - zh)
    out = zh @ wh.T
    if passes == 3:
        out = (zl @ wh.T + zh @ wl.T) + out
    return out[:, :h].reshape(b, d, h).transpose(1, 2)


def test_tf32_round_matches_rna():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-12, -(1 + 2**-11), 1 + 2**-12,
                      3.0e-38, 123456.789])
    got = cin.tf32_round(x)
    # ties go away from zero; below half an ulp rounds down
    assert got[0] == 1.0 and got[1] == 1 + 2**-10 and got[3] == -(1 + 2**-10)
    assert got[2] == 1 + 2**-10 and got[4] == 1.0
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((got - x).abs() <= x.abs() * 2**-11).all()


@pytest.mark.parametrize("fl", [39, 200])
def test_cin_3xtf32_emulation_matches_reference(fl):
    # the full-width layer (F0 = 39, H = 200, D = 10) at B = 16: three TF32
    # passes keep rtol = atol = 2e-4 against the fp32 oracle and the Pallas
    # kernel; one pass does not
    b, f0, h, d = 16, 39, 200, 10
    rng = np.random.default_rng(fl)
    x0, xl, w = cin_operands(rng, b, f0, fl, h, d)
    tx0, txl, tw = (torch.from_numpy(a) for a in (x0, xl, w))
    got = cin_tf32_emulation(tx0, txl, tw)
    plain = ref.cin_layer_ref(tx0, txl, tw)
    want = np.asarray(jax_ops.cin_layer(jnp.asarray(x0), jnp.asarray(xl), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # fp32-level: far inside the tolerance
    assert float((got - plain).abs().max()) < 2e-5
    one_pass = cin_tf32_emulation(tx0, txl, tw, passes=1)
    assert not torch.allclose(one_pass, plain, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,f0,fl,h,d", [
    (1, 39, 200, 200, 10), (7, 39, 39, 200, 10), (300, 39, 200, 200, 10),
    (512, 39, 39, 200, 10), (512, 39, 200, 200, 10), (513, 39, 200, 200, 10),
    (4096, 39, 200, 200, 10), (262144, 39, 39, 200, 10),
    (262144, 39, 200, 200, 10), (96, 12, 20, 70, 3), (100, 12, 20, 70, 4),
    (8192, 150, 20, 30, 4), (256, 6, 400, 40, 10), (40, 5, 8, 300, 4),
    (0, 39, 200, 200, 10)])
def test_cin_plan(b, f0, fl, h, d):
    plan = cin.cin_plan(b, f0, fl, h, d)
    # filter tiles: a built wgmma width, as few tiles as hold H
    assert plan.n_tile in cin.N_TILES and plan.h_pad == plan.n_tile * plan.n_tiles >= h
    assert plan.n_tiles == -(-h // 256) and (plan.n_tiles - 1) * plan.n_tile < h
    m_tiles, n_tiles, splits = plan.grid
    assert (m_tiles, n_tiles, splits) == (plan.m_tiles, plan.n_tiles, plan.splits)
    assert m_tiles * cin.BLOCK_ROWS >= b * d > (m_tiles - 1) * cin.BLOCK_ROWS or b == 0
    # K: i padded to whole 8-wide blocks, walked in units of (chunk, j);
    # k_pad whole 32-float boxes
    assert plan.ib_total == -(-f0 // 8) and plan.k_steps == fl * plan.ib_total
    assert plan.units == -(-plan.ib_total // cin.CHUNK_IB) * fl
    assert plan.k_pad % cin.BOX_K == 0 and 0 <= plan.k_pad - 8 * plan.k_steps < cin.BOX_K
    assert plan.w_split_shape == (2, plan.h_pad, plan.k_pad)
    # every K unit, and so every k8 step, in exactly one split; split sizes
    # differ by at most one unit
    covered = [u for lo, hi in plan.unit_ranges for u in range(lo, hi)]
    assert covered == list(range(plan.units))
    sizes = [hi - lo for lo, hi in plan.unit_ranges]
    assert len(sizes) == splits and max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    steps = [q for lo, hi in plan.step_ranges for q in range(lo, hi)]
    assert steps == list(range(plan.k_steps))
    assert plan.scratch_shape == ((splits, b, h, d) if splits > 1 else None)
    # the ring: at least two stages, within the 227 KB a block can use
    assert 2 <= plan.stages <= cin.MAX_STAGES
    assert plan.smem_bytes == plan.stages * 256 * plan.n_tile + 1024 + 16 * plan.stages
    assert plan.smem_bytes <= 232448
    # the cheapest split under the plan's wave model, the fewest among equals
    tiles = m_tiles * n_tiles
    if tiles:
        costs = [cin.split_cost(tiles, plan.k_steps, s) for s in range(1, plan.units + 1)]
        assert costs[splits - 1] == min(costs) and costs.index(min(costs)) == splits - 1
    if (f0, h, d) == (39, 200, 10):
        # xDeepFM's widths: one 200-wide tile, no filter padding, 4 stages
        assert (plan.n_tile, plan.n_tiles, plan.h_pad, plan.stages) == (200, 1, 200, 4)
        assert plan.ib_total == 5 and plan.k_steps == 5 * fl
        if b == 262144:
            assert splits == 1 and plan.scratch_shape is None and m_tiles == 20480
        if b in (512, 513):
            # one wave: 40 (41) row tiles x 3 thirds of K
            assert splits == 3 and plan.blocks <= 132
            assert plan.scratch_shape == (3, b, 200, 10)
        if b == 1:
            assert m_tiles == 1 and splits == 125


def test_cin_plan_split_model_order():
    # the wave model's order of the splits at B = 512 (40 row tiles, Fl =
    # 200: 1,000 k8 steps), one block per SM: 3 < 8 < 5 < 2 < 4 < 1
    cost = {s: cin.split_cost(40, 1000, s) for s in (1, 2, 3, 4, 5, 8)}
    assert sorted(cost, key=cost.get) == [3, 8, 5, 2, 4, 1]
    plan = cin.cin_plan(512, 39, 200, 200, 10, splits=5)
    assert plan.unit_ranges == ((0, 40), (40, 80), (80, 120), (120, 160), (160, 200))
    assert plan.step_ranges == ((0, 200), (200, 400), (400, 600), (600, 800), (800, 1000))
    # F0 = 150: four chunks of i (5, 5, 5 and 4 blocks); a split's steps
    # follow the chunks' widths
    plan = cin.cin_plan(64, 150, 20, 30, 4, splits=3)
    assert plan.units == 80 and plan.k_steps == 20 * 19
    assert plan.unit_ranges == ((0, 26), (26, 53), (53, 80))
    assert plan.step_ranges == ((0, 130), (130, 265), (265, 380))
    with pytest.raises(ValueError, match="splits"):
        cin.cin_plan(512, 39, 200, 200, 10, splits=201)


def prep_index_c(f0: int, fl: int, k: int) -> int:
    """The prep kernel's index arithmetic for one k (csrc/cin_layer.cu,
    ``cin_layer_kernel_prep``), written out: i * Fl + j, or -1."""
    ib_total = -(-f0 // 8)
    q = k >> 3
    if q >= fl * ib_total:
        return -1
    c = q // (cin.CHUNK_IB * fl)
    r = q - c * cin.CHUNK_IB * fl
    nib = min(cin.CHUNK_IB, ib_total - cin.CHUNK_IB * c)
    j = r // nib
    i = 8 * (cin.CHUNK_IB * c + r - j * nib) + (k & 7)
    return i * fl + j if i < f0 else -1


@pytest.mark.parametrize("f0,fl,h", [(39, 200, 200), (39, 39, 200), (150, 20, 30),
                                     (12, 20, 70), (5, 8, 300), (3, 1, 8)])
def test_cin_weight_layout(f0, fl, h):
    # the prep's w_hi / w_lo in plain torch: every (i, j) once, in the
    # kernel's K order; zeros in the padding; hi + lo within 2^-22 of w
    rng = np.random.default_rng(f0 * fl + h)
    w = torch.from_numpy((rng.normal(size=(h, f0, fl)) / np.sqrt(f0 * fl)).astype(np.float32))
    plan = cin.cin_plan(512, f0, fl, h, 10)
    idx = cin.k_index(f0, fl)
    assert idx.shape == (plan.k_pad,)
    assert sorted(idx[idx >= 0].tolist()) == list(range(f0 * fl))
    assert idx.tolist() == [prep_index_c(f0, fl, k) for k in range(plan.k_pad)]
    ws = cin.weight_layout(w, plan)
    assert ws.shape == plan.w_split_shape and ws.dtype == torch.float32
    hi, lo = ws
    pad = idx < 0
    assert (hi[:, pad] == 0).all() and (lo[:, pad] == 0).all()
    assert (hi[h:] == 0).all() and (lo[h:] == 0).all()
    # both halves are TF32 values (13 low bits clear)
    assert ((ws.view(torch.int32) & 0x1FFF) == 0).all()
    got = torch.zeros(h, f0 * fl)
    got[:, idx[~pad]] = (hi + lo)[:h][:, ~pad]
    want = w.reshape(h, f0 * fl)
    assert ((got - want).abs() <= want.abs() * 2.0**-22).all()
    assert not torch.equal(hi[:h][:, ~pad], want[:, idx[~pad]])   # lo carries bits


# ---------------------------------------------------------------------------
# The level's bookkeeping (csrc/bfs_level.cuh): the plain versions against the
# torch chains the bitmap engine ran before them
# ---------------------------------------------------------------------------

def level_state(v, seed, *, found_density=0.2, big_degrees=False, empty=False):
    """A bitmap BFS level on the CPU: (parent_ext before the relax, after it,
    visited bitmap, degree, level, a ``found`` buffer of junk, an ``acc`` of
    junk).  Visited holds exactly the vertices with a parent before; the
    relax gives parents to some of the others (none when ``empty``), vertex
    31 among them (bit 31 of word 0).  ``big_degrees`` makes the degree sums
    wrap modulo 2^32."""
    rng = np.random.default_rng(seed)
    visited = rng.random(v) < 0.3
    newly = ~visited & (rng.random(v) < found_density) & (not empty)
    if not empty and v > 31:
        visited[31], newly[31] = False, True
    before = np.append(np.where(visited, rng.integers(0, v, v), v), v).astype(np.int32)
    after = before.copy()
    after[:v][newly] = rng.integers(0, v, int(newly.sum()))
    w = padded_bitmap_words(v)
    degree = rng.integers(0, 2**31 - 1 if big_degrees else 300, v).astype(np.int32)
    level = np.where(visited, rng.integers(0, 9, v), -1).astype(np.int32)
    return (torch.from_numpy(before), torch.from_numpy(after),
            pack_bitmap(torch.from_numpy(visited), w), torch.from_numpy(degree),
            torch.from_numpy(level), torch.full((w,), -7, dtype=torch.int32),
            torch.full((ref.ACC_SLOTS,), 12345, dtype=torch.int32))


@pytest.mark.parametrize("case", ["v4096", "v1000", "wrap", "empty", "dense"])
def test_level_delta_plain_matches_the_torch_chain(case):
    v = {"v4096": 4096, "v1000": 1000, "wrap": 4096 + 17, "empty": 1000, "dense": 777}[case]
    before, after, vis, degree, level, found, acc = level_state(
        v, 7, big_degrees=case == "wrap", empty=case == "empty",
        found_density=0.9 if case == "dense" else 0.2)
    lvl = 5
    # the chain: the unvisited snapshot taken before the relax, the delta,
    # its pack, the level fill, the degree sum and the popcount sentinel
    newly = (after[:v] != v) & (before[:v] == v)
    want_found = pack_bitmap(newly, found.shape[0])
    want_level = level.clone().masked_fill_(newly, lvl + 1)
    want_m_next = torch.where(newly, degree, 0).sum().to(torch.int32)
    want_pc = ref.popcount_u32(want_found).sum()
    assert torch.equal(vis, pack_bitmap(before[:v] != v, found.shape[0]))
    ops.bfs_level_delta(after, vis, degree, level, lvl + 1, found, acc)
    assert torch.equal(found, want_found) and torch.equal(level, want_level)
    assert int(acc[ref.ACC_M_NEXT]) == int(want_m_next)
    assert int(acc[ref.ACC_FOUND]) == int(want_pc) == int(newly.sum())
    assert (int(want_pc) == 0) == (case == "empty")
    if case != "empty":
        assert int(found[0]) < 0                      # bit 31 of word 0
    if case == "wrap":
        assert int(torch.where(newly, degree, 0).sum()) >= 2**32


@pytest.mark.parametrize("bottom_up", [False, True])
@pytest.mark.parametrize("case", ["clean", "overlap", "miscount", "last_level"])
def test_level_stats_plain_matches_the_torch_chain(bottom_up, case):
    rng = np.random.default_rng(11 + bottom_up)
    w, max_levels = 1024, 64
    lvl = max_levels - 1 if case == "last_level" else 3
    visited = to_t(rand_u32(rng, (w,), 0.4))
    found = to_t(rand_u32(rng, (w,), 0.1)) & ~visited     # a delta: none of it visited
    nxt, _, count = ref.frontier_update_ref(found, visited)
    if case == "overlap":
        nxt = nxt | visited
    if case == "miscount":
        count = count + 1
    m_f, deg_vis, nnz, m_next = (int(x) for x in rng.integers(-2**31, 2**31, 4))
    pc = ref.popcount_u32(found).sum()
    acc = torch.tensor([m_f, deg_vis, nnz, m_next, int(pc), lvl], dtype=torch.int32)
    stats = torch.full((ref.STATS_ROWS, max_levels), -1, dtype=torch.int32)
    stats[ref.STATS_FS:ref.STATS_SE + 1].zero_()
    want = stats.clone()
    # the chain: the host ints the engine wrote, the sentinels as it summed
    # them, the scanned-edge estimate, the host's chunk count, and the degree
    # sums moved on
    want[ref.STATS_DIR, lvl] = hybrid_bfs.BOTTOM_UP if bottom_up else hybrid_bfs.TOP_DOWN
    want[ref.STATS_FS, lvl] = 12345
    s1 = count == ref.popcount_u32(found).sum()
    s2 = ref.popcount_u32(nxt & visited).sum() == 0
    s3 = int(lvl + 1 <= max_levels)
    want[ref.STATS_OK, lvl] = s1.to(torch.int32) + 2 * s2.to(torch.int32) + 4 * s3
    acc_t = acc.clone()
    want[ref.STATS_SE, lvl] = (acc_t[ref.ACC_NNZ] - acc_t[ref.ACC_DEG_VIS] if bottom_up
                               else acc_t[ref.ACC_M_F])
    if bottom_up:
        want[ref.STATS_CH, lvl] = 64
    want_acc = acc.clone()
    want_acc[ref.ACC_M_F] = acc_t[ref.ACC_M_NEXT]
    want_acc[ref.ACC_DEG_VIS] = acc_t[ref.ACC_DEG_VIS] + acc_t[ref.ACC_M_NEXT]
    want_acc[ref.ACC_LEVELS] = lvl + 1
    ops.bfs_level_stats(nxt, visited, count, acc, stats, lvl, bottom_up, 12345, 64)
    assert torch.equal(stats, want) and torch.equal(acc, want_acc)
    assert int(stats[ref.STATS_OK, lvl]) == {"clean": 7, "overlap": 5, "miscount": 6,
                                             "last_level": 7}[case]


@pytest.mark.parametrize("k,v", [(4096, 10_000), (4096, 4096), (8192, 5000),
                                 (1000 + 17, 3000), (0, 3000)])
def test_level_stats_counts_the_unvisited_core_rows(k, v):
    # a core below, at and past V (the engine passes min(K, V): rows at or
    # past V count as visited), a bound that is no multiple of 32, no core;
    # the stats and acc the same as without the count
    rng = np.random.default_rng(k + v)
    visited = rng.random(v) < 0.6
    nxt = ~visited & (rng.random(v) < 0.5)
    kk = min(k, v)
    want = int((~visited[:kk] & ~nxt[:kk]).sum())
    w = padded_bitmap_words(v)
    vis_bm, next_bm = (pack_bitmap(torch.from_numpy(m), w) for m in (visited, nxt))
    count = ref.popcount_u32(next_bm).sum().to(torch.int32)
    acc = torch.tensor([5, 6, 7, 8, int(count), 0], dtype=torch.int32)
    outs = []
    for unvisited in (None, torch.full((), -9, dtype=torch.int32)):
        a = acc.clone()
        stats = torch.full((ref.STATS_ROWS, 8), -1, dtype=torch.int32)
        ops.bfs_level_stats(next_bm, vis_bm, count, a, stats, 2, True, 3, 64, kk, unvisited)
        outs.append((stats, a))
    assert int(unvisited) == want
    assert 0 < want < kk or kk == want == 0
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    with pytest.raises(ValueError, match="bfs_level_stats: core_rows"):
        ops.bfs_level_stats(next_bm, vis_bm, count, acc, stats, 2, True, 3, 64, 32 * w + 1,
                            unvisited)


def live_chunks_brute(src_lo, src_hi, frontier_bm) -> int:
    """The chunks with a nonzero frontier word in their clamped word range,
    chunk by chunk."""
    words, w = frontier_bm.numpy(), frontier_bm.shape[0]
    n = 0
    for lo, hi in zip(src_lo.tolist(), src_hi.tolist()):
        if hi >= lo:
            a, b = min(max(lo // 32, 0), w - 1), min(max(hi // 32, 0), w - 1)
            n += bool(np.any(words[a:b + 1]))
    return n


@pytest.mark.parametrize("case", ["kron12", "nocore12", "v32768", "ranges"])
@pytest.mark.parametrize("density", [0.0005, 0.02, 0.5])
def test_live_chunks_plain_matches_the_torch_chain(case, density):
    rng = np.random.default_rng(int(density * 1e4))
    if case == "ranges":
        # empty chunks, ranges past either end of the bitmap, one word wide
        w = 1024
        src_lo = torch.tensor([0, 5, 40, 33000, 2**31 - 1, -100, 31, 32767], dtype=torch.int32)
        src_hi = torch.tensor([-1, 4000, 40, 40000, 2**31 - 1, 70, 32, 0], dtype=torch.int32)
    else:
        _, degree, _, rows = relax_graph(case)
        w = padded_bitmap_words(degree.shape[0])
        src_lo, src_hi = rows.src_lo, rows.src_hi
        assert bool((src_hi >= src_lo).any())
    frontier = to_t(rand_u32(rng, (w,), density))
    stats = torch.full((ref.STATS_ROWS, 8), -1, dtype=torch.int32)
    want = int(ref.chunk_range_mask(src_lo, src_hi, frontier).sum())   # the chain
    ops.bfs_live_chunks(frontier, src_lo, src_hi, stats, 2)
    assert int(stats[ref.STATS_CH, 2]) == want == live_chunks_brute(src_lo, src_hi, frontier)
    assert int((stats != -1).sum()) == 1


@pytest.mark.parametrize("k,v", [(4096, 1000), (1024, 4096 + 17), (2048, 2048)])
def test_core_merge_plain_matches_the_torch_chain(k, v):
    # a core larger than V (a tiny graph's padded core), smaller, equal
    rng = np.random.default_rng(k + v)
    before, _, vis, *_ = level_state(v, k)
    cand = torch.from_numpy(np.where(rng.random(k) < 0.4, ref.BIG,
                                     rng.integers(0, v, k)).astype(np.int32))
    want, got = before.clone(), before.clone()
    # the chain of the engine's core step after core_spmv
    kk = min(k, v)
    rows = torch.arange(kk, dtype=torch.int32)
    won = (cand[:kk] < ref.BIG) & ~bit_at(vis, rows)
    prefix = want[:kk]
    prefix.copy_(torch.minimum(prefix, torch.where(won, cand[:kk], v)))
    ops.bfs_core_merge(cand, vis, got)
    assert torch.equal(got, want) and not torch.equal(got, before)


def test_level_kernels_refuse_bad_operands():
    before, after, vis, degree, level, found, acc = level_state(100, 1)
    stats = torch.zeros((ref.STATS_ROWS, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="bfs_level_delta: found"):
        ops.bfs_level_delta(after, vis, degree, level, 1, found[:3], acc)
    with pytest.raises(ValueError, match="bfs_level_delta: acc"):
        ops.bfs_level_delta(after, vis, degree, level, 1, found, acc[:5])
    with pytest.raises(ValueError, match="bfs_level_stats: stats"):
        ops.bfs_level_stats(vis, vis, acc[0], acc, stats, 4, False, 5, 1)
    with pytest.raises(ValueError, match="bfs_live_chunks: src_hi"):
        ops.bfs_live_chunks(vis, acc[:2], acc[:3], stats, 0)
    with pytest.raises(ValueError, match="bfs_core_merge: cand"):
        ops.bfs_core_merge(degree.long(), vis, before)
