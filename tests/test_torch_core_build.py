"""The dense core built a block of rows at a time (``heavy._build_core``)
against the one-shot scatter it replaced, bit for bit.

The one-shot build, copied below, scatters every core bit into one int64
plane of K * K/32 words and wraps it to int32; the blocked build does the
same for the CSR slice of each block of rows.  Cases: a Kronecker graph at
scale 12 (K = 4,096, every vertex a core row) and a graph made here whose
core has empty rows and bits in column 31 of their words, each with a
budget of one block, blocks of one row, and blocks of uneven length that do
not divide K.  On the card, a scale-18 build stays within the result, the
block budget and the edge arrays.  The file imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import graph_build, heavy, kronecker, reorder
from repro_torch.kernels.ref import wrap_i32

torch.set_num_threads(2)

ONE_BLOCK = 1 << 40
BUDGETS = {"one-block": ONE_BLOCK, "one-row": 1, "uneven": 300_000}


def one_shot(src, dst, valid, k):
    """The core as one int64 scatter over every entry, then wrapped."""
    words = k // 32
    in_core = valid & (src < k) & (dst < k)
    word_idx = torch.where(in_core, src.to(torch.int64) * words + dst.to(torch.int64) // 32,
                           k * words)
    bit = torch.where(in_core, torch.ones_like(word_idx) << (dst.to(torch.int64) % 32), 0)
    flat = torch.zeros(k * words + 1, dtype=torch.int64, device=src.device)
    flat.index_add_(0, word_idx, bit)
    return wrap_i32(flat[:-1]).reshape(k, words)


def sorted_kronecker(scale, device="cpu"):
    e = kronecker.generate_edges(3, scale, 16, device=device)
    g = graph_build.build_csr(e)
    return graph_build.build_csr(reorder.relabel_edges(e, reorder.degree_reorder(g.degree)))


def sparse_core_graph():
    """V = 8,192 with K = 4,096: core rows 1,000-1,999 have no entry, rows
    3,000-4,095 none in the core, and a fifth of the edges land in column 31
    of a word (2,015 and 31 among them)."""
    rng = np.random.default_rng(5)
    n = 40_000
    src = rng.integers(0, 8192, n)
    dst = rng.integers(0, 8192, n)
    dst[: n // 5] = rng.integers(0, 8192 // 32, n // 5) * 32 + 31
    src[:2], dst[:2] = [0, 2999], [2015, 31]
    empty = ((src >= 1000) & (src < 2000)) | ((dst >= 1000) & (dst < 2000)) \
        | (((src >= 3000) & (src < 4096)) & (dst < 4096)) \
        | (((dst >= 3000) & (dst < 4096)) & (src < 4096))
    src, dst = src[~empty], dst[~empty]
    e = kronecker.EdgeList(torch.from_numpy(src.astype(np.int32)),
                           torch.from_numpy(dst.astype(np.int32)), 8192)
    return graph_build.build_csr(e), 4096


_GRAPHS: dict = {}


def graph(case):
    """(CSR, K) of a case, cached."""
    if case not in _GRAPHS:
        if case == "kron12":
            g = sorted_kronecker(12)
            _GRAPHS[case] = (g, heavy.pad_k(int(heavy.heavy_count(g.degree, 100)),
                                            g.num_vertices))
        else:
            _GRAPHS[case] = sparse_core_graph()
    return _GRAPHS[case]


def padded_offsets(g, k):
    ro = g.row_offsets[: k + 1].numpy()
    return np.pad(ro, (0, k + 1 - len(ro)), mode="edge")


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("case", ["kron12", "sparse"])
def test_blocked_core_equals_the_one_shot_scatter(case, budget):
    g, k = graph(case)
    assert k == 4096
    src, dst, valid = graph_build.csr_to_edge_arrays(g)
    bounds = heavy.core_blocks(padded_offsets(g, k), k, BUDGETS[budget])
    sizes = np.diff(bounds)
    if budget == "one-block":
        assert len(sizes) == 1
    elif budget == "one-row":
        assert (sizes == 1).all()
    else:
        assert len(sizes) > 2 and len(set(sizes.tolist())) > 1 and k % sizes[0]
    got = heavy._build_core(src, dst, valid, g.row_offsets, k, BUDGETS[budget])
    want = one_shot(src, dst, valid, k)
    assert got.dtype == torch.int32 and got.shape == (k, k // 32)
    assert torch.equal(got, want)
    # what the cases are there for: bits in column 31, and empty core rows
    assert bool((got < 0).any())
    if case == "sparse":
        assert not bool(got[1000:2000].any()) and not bool(got[3000:].any())
        assert bool(got[:1000].any()) and bool(got[2000:3000].any())


@pytest.mark.parametrize("budget", [1, 10_000, 300_000, ONE_BLOCK])
def test_core_blocks_cover_the_core_within_the_budget(budget):
    # contiguous blocks from 0 to K, each within the budget or one row long
    g, k = graph("kron12")
    ro = padded_offsets(g, k)
    bounds = heavy.core_blocks(ro, k, budget)
    assert bounds[0] == 0 and bounds[-1] == k and all(np.diff(bounds) > 0)
    words = k // 32
    for r0, r1 in zip(bounds, bounds[1:]):
        cost = (r1 - r0) * words * heavy._WORD_BYTES + (ro[r1] - ro[r0]) * heavy._EDGE_BYTES
        assert cost <= budget or r1 == r0 + 1


def test_build_heavy_core_is_blocked_by_the_module_budget(monkeypatch):
    # the entry point reads the module's budget when it runs: a core built
    # in one-row blocks is the one built in one block
    g, k = graph("kron12")
    whole = heavy.build_heavy_core(g)
    monkeypatch.setattr(heavy, "CORE_BLOCK_BYTES", 1)
    rows = heavy.build_heavy_core(g)
    assert whole.k == rows.k == k
    for f in ("a_core", "k_heavy", "halo_src", "halo_dst", "halo_valid", "core_nnz"):
        assert torch.equal(getattr(rows, f), getattr(whole, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [16 << 20, heavy.CORE_BLOCK_BYTES])
def test_scale18_build_on_card_stays_within_result_budget_and_edges(budget):
    # the core's build holds no more at once than its int32 result, one
    # block's budget and the edge arrays it makes (the entries' sources and
    # edge_sources' two int32 temporaries), and equals the one-shot scatter
    # on the card
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = sorted_kronecker(18, dev)
    k = heavy.pad_k(int(heavy.heavy_count(g.degree, 100)), g.num_vertices)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    src, dst, valid = graph_build.csr_to_edge_arrays(g)
    a_core = heavy._build_core(src, dst, valid, g.row_offsets, k, budget)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    edge_arrays = g.padded_edges * 12
    result = a_core.numel() * 4
    assert peak <= result + budget + edge_arrays, (peak, result, budget, edge_arrays)
    assert torch.equal(a_core, one_shot(src, dst, valid, k))
