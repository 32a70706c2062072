"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every test carries the ``cuda`` marker and skips without a CUDA device (the
kernels have no CPU or interpret mode).  The file imports no JAX, so it also
runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bitmap_ops, frontier_spmv, ops, ref

torch.set_num_threads(2)


def rand_u32(rng, shape, density=0.5):
    bits = rng.random(shape + (32,)) < density
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little") \
        .view(np.uint32).reshape(shape)


def to_t(words: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32).copy()).to(device)


def corner_cases():
    w = 1024
    ones = np.full(w, 0xFFFFFFFF, np.uint32)
    zeros = np.zeros(w, np.uint32)
    bit31 = np.full(w, 0x80000000, np.uint32)
    return [(ones, zeros), (ones, ones), (zeros, ones), (bit31, zeros),
            (ones, bit31), (bit31, bit31)]


def min_neighbour_case():
    # row 0 connects to {5, 70, 4000}; frontier = {70, 4000}
    k = 4096
    a = np.zeros((k, k // 32), np.uint32)
    for j in (5, 70, 4000):
        a[0, j // 32] |= np.uint32(1) << np.uint32(j % 32)
    f = np.zeros((k // 32,), np.uint32)
    for j in (70, 4000):
        f[j // 32] |= np.uint32(1) << np.uint32(j % 32)
    return a, f


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_words", [1024, 32768])
@pytest.mark.parametrize("density", [0.01, 0.5])
def test_frontier_update_kernel_matches_plain(cuda, n_words, density):
    rng = np.random.default_rng(n_words)
    nxt = to_t(rand_u32(rng, (n_words,), density), cuda)
    vis = to_t(rand_u32(rng, (n_words,), density), cuda)
    got = bitmap_ops.frontier_update(nxt, vis)
    want = ref.frontier_update_ref(nxt, vis)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(6))
def test_frontier_update_kernel_corners(cuda, case):
    nxt, vis = corner_cases()[case]
    got = bitmap_ops.frontier_update(to_t(nxt, cuda), to_t(vis, cuda))
    want = ref.frontier_update_ref(to_t(nxt, cuda), to_t(vis, cuda))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_tile", [1, 8, 32])
@pytest.mark.parametrize("density", [0.001, 0.05])
def test_core_spmv_kernel_matches_plain(cuda, rows_per_tile, density):
    rng = np.random.default_rng(7)
    k = 4096
    a = to_t(rand_u32(rng, (k, k // 32), density), cuda)
    f = to_t(rand_u32(rng, (k // 32,), 0.1), cuda)
    got = frontier_spmv.core_spmv(a, f, rows_per_tile=rows_per_tile)
    assert torch.equal(got, ref.core_spmv_ref(a, f))


@pytest.mark.cuda
def test_core_spmv_kernel_min_neighbor(cuda):
    a, f = min_neighbour_case()
    got = frontier_spmv.core_spmv(to_t(a, cuda), to_t(f, cuda))
    assert int(got[0]) == 70 and int(got[1]) == ref.BIG


@pytest.mark.cuda
def test_kernel_launches_counted(cuda):
    before = ops.launch_counts()
    a, f = min_neighbour_case()
    nxt, vis = corner_cases()[0]
    ops.core_spmv(to_t(a, cuda), to_t(f, cuda))
    ops.frontier_update(to_t(nxt, cuda), to_t(vis, cuda))
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "frontier_update": 1, "core_spmv": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [False, True])
def test_bitmap_engine_on_card_matches_cpu(cuda, batch):
    # the whole engine through the kernels equals the plain-version run
    from repro_torch.core import pipeline
    from repro_torch.core.kronecker import EdgeList, generate_edges
    from repro_torch.core.plan import compile_plan
    e = generate_edges(5, 12, device="cpu")
    # torch's CPU and CUDA generators give different streams: sample the
    # search keys once, in the edge list's labels, for both devices
    keys = e.src[e.src != e.dst][:3].numpy()
    runs = []
    for dev in ("cpu", "cuda"):
        cfg = pipeline.Graph500Config.ladder(
            "pre-g500-batch" if batch else "pre-g500", scale=12, n_roots=3,
            device=dev)
        built = pipeline.build(cfg, edges=EdgeList(e.src.to(dev), e.dst.to(dev),
                                                   e.num_vertices))
        roots = pipeline.search_keys(cfg, built, keys)
        res = compile_plan(cfg.to_plan(), built, device=dev).run(roots, check="full")
        assert res.run.all_valid and not any(res.run.check_counts.values())
        runs.append(res)
    np.testing.assert_array_equal(runs[0].parent, runs[1].parent)
    np.testing.assert_array_equal(runs[0].level, runs[1].level)
    assert runs[0].run.edges == runs[1].run.edges
