"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every test carries the ``cuda`` marker and skips without a CUDA device (the
kernels have no CPU or interpret mode).  The file imports no JAX, so it also
runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import bitmap_ops, cin, frontier_spmv, ops, ref, spmv_mxu

from core_spmv_cases import core_steps, first_hit_core, walked_words

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
@pytest.mark.parametrize("n_words", [1024, 2**21])
def test_frontier_update_back_to_back_counts(cuda, n_words):
    # the second launch on the stream finds the ticket the first one reset;
    # 2^21 words (> 528 blocks x 256 threads x 4) runs the grid-stride loop
    rng = np.random.default_rng(n_words + 1)
    outs, wants = [], []
    for density in (0.3, 0.02, 0.0):
        nxt = to_t(rand_u32(rng, (n_words,), density), cuda)
        vis = to_t(rand_u32(rng, (n_words,), 0.1), cuda)
        outs.append(bitmap_ops.frontier_update(nxt, vis))
        wants.append(ref.frontier_update_ref(nxt, vis))
    torch.cuda.synchronize()
    for got, want in zip(outs, wants):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert int(outs[2][2]) == 0 and int(outs[0][2]) > int(outs[1][2]) > 0


@pytest.mark.cuda
def test_frontier_update_out_buffers(cuda):
    # the engine's form: outputs into caller buffers, reused across calls
    rng = np.random.default_rng(3)
    w = 32768
    out = (torch.empty(w, dtype=torch.int32, device=cuda),
           torch.empty(w, dtype=torch.int32, device=cuda),
           torch.empty((), dtype=torch.int32, device=cuda))
    for density in (0.5, 0.01):
        nxt = to_t(rand_u32(rng, (w,), density), cuda)
        vis = to_t(rand_u32(rng, (w,), density), cuda)
        got = bitmap_ops.frontier_update(nxt, vis, out=out)
        assert all(g is o for g, o in zip(got, out))
        for g, want in zip(got, ref.frontier_update_ref(nxt, vis)):
            assert torch.equal(g, want)


@pytest.mark.cuda
def test_frontier_update_refuses_aliased_out(cuda):
    w = 1024
    nxt = torch.zeros(w, dtype=torch.int32, device=cuda)
    vis = torch.zeros(w, dtype=torch.int32, device=cuda)
    spare = torch.zeros(2 * w, dtype=torch.int32, device=cuda)
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    before = bitmap_ops.KERNEL.launches
    for out in ((nxt, spare[:w], count), (spare[:w], vis, count),
                (spare[:w], spare[:w], count), (spare[:w], spare[w:], spare[5])):
        with pytest.raises(ValueError, match="aliases"):
            bitmap_ops.frontier_update(nxt, vis, out=out)
    assert bitmap_ops.KERNEL.launches == before


@pytest.mark.cuda
def test_frontier_update_scratch_per_stream(cuda):
    rng = np.random.default_rng(5)
    nxt = to_t(rand_u32(rng, (4096,), 0.2), cuda)
    vis = to_t(rand_u32(rng, (4096,), 0.2), cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = bitmap_ops.frontier_update(nxt, vis)
    torch.cuda.current_stream().wait_stream(side)
    main = bitmap_ops.frontier_update(nxt, vis)
    torch.cuda.synchronize()
    assert torch.equal(got[2], main[2])
    dev = torch.cuda.current_device()
    assert bitmap_ops.scratch_for(dev, side.cuda_stream) != \
        bitmap_ops.scratch_for(dev, torch.cuda.current_stream().cuda_stream)


def core_case(case, device):
    """(core, frontier) on ``device`` for :func:`test_core_spmv_kernel_matches_plain`:
    random cores at K = 4,096; rows whose first hit sits at a group's edges
    (1,000 words a row: 250 vectors, so the last group is short); and a
    scale-22-like bottom-up level, a sparse frontier over K = 65,536, where
    most rows read far or to their end."""
    rng = np.random.default_rng(7)
    if case.startswith("random"):
        k = 4096
        a = rand_u32(rng, (k, k // 32), float(case.split("-")[1]))
        f = rand_u32(rng, (k // 32,), 0.1)
    elif case == "first-hits":
        a, f, _ = first_hit_core(rng, 4096, 1000)
    else:
        k = 65536
        gen = torch.Generator(device=device).manual_seed(7)
        a = torch.randint(-2**31, 2**31, (k, k // 32), dtype=torch.int32, device=device,
                          generator=gen)
        for _ in range(4):      # 1 bit in 32: about 2,048 columns a row
            a &= torch.randint(-2**31, 2**31, a.shape, dtype=torch.int32, device=device,
                               generator=gen)
        f = to_t(rand_u32(rng, (k // 32,), 0.0002), device)
        return a, f
    return to_t(a, device), to_t(f, device)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_tile", [1, 8, 32])
@pytest.mark.parametrize("case", ["random-0.001", "random-0.05", "first-hits",
                                  "sparse-k65536"])
def test_core_spmv_kernel_matches_plain(cuda, rows_per_tile, case):
    # bit for bit, and the kernel's count of words read (whole groups up to
    # each row's first hit) equals the plain version's, over two launches
    a, f = core_case(case, cuda)
    words, want_words = (torch.zeros((), dtype=torch.int64, device=cuda) for _ in range(2))
    want = ref.core_spmv_ref(a, f, want_words)
    for _ in range(2):
        got = frontier_spmv.core_spmv(a, f, rows_per_tile=rows_per_tile, words_read=words)
        assert torch.equal(got, want)
    assert int(words) == 2 * int(want_words) > 0
    assert torch.equal(frontier_spmv.core_spmv(a, f, rows_per_tile=rows_per_tile), want)
    if case == "first-hits":
        assert int(want_words) == walked_words(a.cpu().numpy().view(np.uint32),
                                               f.cpu().numpy().view(np.uint32))
    if case == "sparse-k65536":
        hit = want < ref.BIG
        assert 0 < int(hit.sum()) < a.shape[0]  # rows that end early and rows read whole


@pytest.mark.cuda
def test_core_spmv_refuses_another_group_size(cuda):
    # the kernel's group is compiled in: a launch with another size than the
    # plain version counts with fails, and so does a counter of another type
    a, f = core_case("first-hits", cuda)
    out = torch.empty(a.shape[0], dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    with pytest.raises(RuntimeError, match="core_spmv_launch"):
        frontier_spmv.KERNEL(a.data_ptr(), f.data_ptr(), out.data_ptr(), a.shape[0],
                             a.shape[1], 8, ref.CORE_GROUP_STEPS + 1, None, stream)
    with pytest.raises(ValueError, match="words_read"):
        frontier_spmv.core_spmv(a, f, words_read=torch.zeros((), dtype=torch.int32,
                                                             device=cuda))


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
    a8 = torch.ones((128, 128), dtype=torch.int8, device=cuda)
    ops.multi_source_spmv(a8, a8)
    x = torch.ones((4, 3, 2), device=cuda)
    ops.cin_layer(x, x, torch.ones((5, 3, 3), device=cuda))
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    ops.sssp_relax(torch.zeros(1, dtype=torch.int64, device=cuda),
                   torch.zeros(1, dtype=torch.bool, device=cuda), one,
                   torch.zeros(1, dtype=torch.int64, device=cuda), one - 1, one)
    path = dict(bm=one, deg=one, rs=torch.zeros(1, dtype=torch.int64, device=cuda),
                dst=one - 1, p=torch.ones(2, dtype=torch.int32, device=cuda))
    ops.bfs_relax_top_down(path["bm"], path["bm"], path["deg"], path["rs"], path["dst"],
                           path["p"])
    ops.bfs_relax_bottom_up(path["bm"], path["p"], path["deg"], path["rs"], path["dst"],
                            one[:0])
    acc = torch.zeros(ref.ACC_SLOTS, dtype=torch.int32, device=cuda)
    stats = torch.zeros((ref.STATS_ROWS, 2), dtype=torch.int32, device=cuda)
    ops.bfs_level_delta(path["p"], path["bm"], path["deg"], one.clone(), 1, one.clone(), acc)
    ops.bfs_level_stats(path["bm"], path["bm"], acc[0], acc, stats, 0, False, 1, 1)
    ops.bfs_live_chunks(path["bm"], one, one, stats, 0)
    ops.bfs_core_merge(one, path["bm"], path["p"])
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "frontier_update": 1, "core_spmv": 1, "spmv_mxu": 1, "cin_layer": 1,
        "sssp_relax": 1, "bfs_relax": 2, "bfs_level_delta": 1, "bfs_level_stats": 1,
        "bfs_live_chunks": 1, "bfs_core_merge": 1}


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


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["reference-3.0.0", "pre-g500-legacy"])
def test_legacy_engines_on_card_match_cpu(cuda, rung):
    # the reference and legacy engines on the card (the legacy one through
    # the core_spmv kernel, one launch a bottom-up level) equal their CPU
    # runs on one graph
    from repro_torch.core import pipeline
    from repro_torch.core.hybrid_bfs import BOTTOM_UP
    from repro_torch.core.kronecker import EdgeList
    from repro_torch.core.plan import compile_plan
    rng = np.random.default_rng(12)
    src = torch.from_numpy(rng.integers(0, 4096, 40000).astype(np.int32))
    dst = torch.from_numpy((rng.pareto(1.5, 40000) * 40).astype(np.int64)
                           .clip(0, 4095).astype(np.int32))
    keys = src[:3].numpy()
    runs = []
    for dev in ("cpu", "cuda"):
        cfg = pipeline.Graph500Config.ladder(rung, scale=12, n_roots=3, device=dev)
        built = pipeline.build(cfg, edges=EdgeList(src.to(dev), dst.to(dev), 4096))
        roots = pipeline.search_keys(cfg, built, keys)
        compiled = compile_plan(cfg.to_plan(), built, device=dev)
        before = ops.launch_counts()["core_spmv"]
        res = compiled.run(roots, check="full")
        launches = ops.launch_counts()["core_spmv"] - before
        assert res.run.all_valid and not any(res.run.check_counts.values())
        runs.append(res)
    np.testing.assert_array_equal(runs[0].parent, runs[1].parent)
    np.testing.assert_array_equal(runs[0].level, runs[1].level)
    if rung == "pre-g500-legacy":
        # timed traversals plus the warm-up of the first root
        n_bu = sum(int((compiled.bfs(int(r)).stats.direction == BOTTOM_UP).sum())
                   for r in [roots[0], *roots])
        assert launches == n_bu > 0


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["grid", "erdos_renyi"])
@pytest.mark.parametrize("batch", [False, True])
def test_sssp_on_card_matches_oracle(cuda, family, batch):
    from repro_torch.core import (build_csr, edge_view, sssp_oracle,
                                  with_edge_weights)
    from repro_torch.core.plan import PreparedGraph, TraversalPlan, compile_plan
    from repro_torch.data.graphs import erdos_renyi_graph, grid_graph
    el = (grid_graph(64, seed=5, device=cuda) if family == "grid"
          else erdos_renyi_graph(4096, seed=7, device=cuda))
    g = build_csr(el)
    ev = with_edge_weights(edge_view(g), seed=2)
    roots = np.array([0, 7], np.int64)
    res = compile_plan(TraversalPlan(kernel="sssp", batch_roots=batch),
                       PreparedGraph(ev=ev, degree=g.degree), device=cuda)
    rows = (res.bfs(roots) if batch else None)
    args = (ev.src.cpu().numpy(), ev.dst.cpu().numpy(), ev.valid.cpu().numpy(),
            ev.weight.cpu().numpy(), g.num_vertices)
    for i, r in enumerate(roots):
        got = res.bfs(int(r)) if not batch else None
        parent = rows.parent[i] if batch else got.parent
        dist = rows.level[i] if batch else got.level
        p, d = sssp_oracle(*args, int(r))
        np.testing.assert_array_equal(parent.cpu().numpy(), p)
        np.testing.assert_array_equal(dist.cpu().numpy(), d)


def weighted_graph(family, device):
    """(weighted EdgeView, degree) of a small graph of ``family``, built on
    ``device``; ``hub``: a star whose centre has a row of 70,000 entries,
    on a ring."""
    from repro_torch.core import build_csr, edge_view, kronecker, with_edge_weights
    from repro_torch.core.kronecker import EdgeList
    from repro_torch.data.graphs import erdos_renyi_graph, grid_graph
    if family == "kronecker":
        el = kronecker.generate_edges(3, 12, device=device)
    elif family == "grid":
        el = grid_graph(64, seed=5, device=device)
    elif family == "erdos_renyi":
        el = erdos_renyi_graph(4096, seed=7, device=device)
    else:
        n = 70_001
        ids = torch.arange(1, n, dtype=torch.int32, device=device)
        el = EdgeList(src=torch.cat([torch.zeros_like(ids), ids]),
                      dst=torch.cat([ids, ids % (n - 1) + 1]), num_vertices=n)
    g = build_csr(el)
    return with_edge_weights(edge_view(g), seed=2), g.degree


def relax_round(ev, degree, seed, density):
    """A round's relax operands on ev's device: distances in a narrow range
    (ties), some past 2^31, some unreached; a frontier of reached vertices."""
    rng = np.random.default_rng(seed)
    v = ev.num_vertices
    dist = rng.integers(0, 600, v).astype(np.uint64)
    dist[rng.random(v) < 0.1] += 2**31
    dist[rng.random(v) < 0.3] = 0xFFFFFFFF
    parent = np.where(dist == 0xFFFFFFFF, v, rng.integers(0, v, v)).astype(np.uint64)
    front = (rng.random(v) < density) & (dist != 0xFFFFFFFF)
    front[0] = dist[0] != 0xFFFFFFFF
    changed = front | (rng.random(v) < 0.1)
    dev = ev.dst.device
    state = torch.from_numpy(((dist << np.uint64(32)) | parent).view(np.int64)).to(dev)
    front_t = torch.from_numpy(front).to(dev)
    return (state, torch.from_numpy(changed).to(dev) & ~front_t,
            torch.where(front_t, degree, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["kronecker", "grid", "erdos_renyi", "hub"])
@pytest.mark.parametrize("density", [0.02, 0.6])
def test_sssp_relax_kernel_matches_plain(cuda, family, density):
    # bit for bit: the unsigned minimum of the packed keys does not depend
    # on the atomics' order; twice on the card gives the same words
    from repro_torch.core.bfs_steps import edge_rows
    ev, degree = weighted_graph(family, cuda)
    rows = edge_rows(ev, degree, weighted=True)
    if family == "hub":
        assert int(degree.max()) > 65_536
    state, changed, front_deg = relax_round(ev, degree, 11, density)
    outs = []
    for fn in (ref.sssp_relax_ref, ops.sssp_relax, ops.sssp_relax):
        st, ch = state.clone(), changed.clone()
        fn(st, ch, front_deg, rows.row_start, rows.dst, rows.weight)
        outs.append((st, ch))
    torch.cuda.synchronize()
    for st, ch in outs[1:]:
        assert torch.equal(st, outs[0][0])
        assert torch.equal(ch, outs[0][1])
    assert not torch.equal(outs[0][0], state)      # the round changed something


@pytest.mark.cuda
def test_sssp_relax_scratch_per_stream(cuda):
    # two streams each keep their own scratch; a new vertex count on a
    # stream replaces its scratch; integer weights take no real-weight scratch
    from repro_torch.core.bfs_steps import edge_rows
    from repro_torch.kernels import sssp_relax
    ev, degree = weighted_graph("erdos_renyi", cuda)
    rows = edge_rows(ev, degree, weighted=True)
    state, changed, front_deg = relax_round(ev, degree, 3, 0.3)
    args = (front_deg, rows.row_start, rows.dst, rows.weight)
    want_s, want_c = state.clone(), changed.clone()
    ref.sssp_relax_ref(want_s, want_c, *args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    outs = [(state.clone(), changed.clone()) for _ in range(2)]
    with torch.cuda.stream(side):
        ops.sssp_relax(*outs[0], *args)
    ops.sssp_relax(*outs[1], *args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for st, ch in outs:
        assert torch.equal(st, want_s) and torch.equal(ch, want_c)
    dev = torch.cuda.current_device()
    v = ev.num_vertices
    main = torch.cuda.current_stream().cuda_stream
    assert sssp_relax.scratch_for(dev, side.cuda_stream, v) != \
        sssp_relax.scratch_for(dev, main, v)
    assert sssp_relax.scratch_for._sets[(dev, main)][0] == v
    sssp_relax.scratch_for(dev, main, v + 1)
    assert sssp_relax.scratch_for._sets[(dev, main)][0] == v + 1
    assert (dev, side.cuda_stream) not in sssp_relax.real_scratch_for._sets


@pytest.mark.cuda
def test_sssp_relax_one_launch_a_round(cuda):
    from repro_torch.core.plan import PreparedGraph, TraversalPlan, compile_plan
    ev, degree = weighted_graph("kronecker", cuda)
    c = compile_plan(TraversalPlan(kernel="sssp", batch_roots=False),
                     PreparedGraph(ev=ev, degree=degree), device=cuda)
    root = int(torch.argmax(degree))
    before = ops.launch_counts()
    res = c.bfs(root)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    rounds = int(res.stats.levels)
    assert rounds > 1
    assert {k: after[k] - before[k] for k in after} == {
        "frontier_update": 0, "core_spmv": 0, "spmv_mxu": 0, "cin_layer": 0,
        "sssp_relax": rounds, "bfs_relax": 0, "bfs_level_delta": 0, "bfs_level_stats": 0,
        "bfs_live_chunks": 0, "bfs_core_merge": 0}


def real_relax_round(ev, degree, seed, density):
    """A round's relax operands with float32 distances and weights: some
    weights 0 or 2^-24 (under half an ulp of distances at 2 and past), the
    distances from a few values (ties), some unreached, hop counts in the
    keys' low halves up to their maximum; and the rows' weight plane."""
    rng = np.random.default_rng(seed)
    v = ev.num_vertices
    pbits, hmax = ref.real_key_bits(v)
    dist = rng.choice(np.array([0.0, 0.5, 2.25, 2.25 + 2**-22, 3.0, 0.125], np.float32), v)
    dbits = dist.view(np.uint32).astype(np.uint64)
    unreached = rng.random(v) < 0.3
    hops = rng.integers(0, 4, v).astype(np.uint64)
    hops[rng.random(v) < 0.05] = hmax
    low = (hops << np.uint64(pbits)) | rng.integers(0, v, v).astype(np.uint64)
    key = np.where(unreached, (np.uint64(0xFFFFFFFF) << np.uint64(32)) | np.uint64(v),
                   (dbits << np.uint64(32)) | low)
    front = (rng.random(v) < density) & ~unreached
    front[0] = not unreached[0]
    changed = front | (rng.random(v) < 0.1)
    dev = ev.dst.device
    n = ev.weight.shape[0]
    kind = torch.from_numpy(rng.random(n)).to(dev)
    w = ev.weight.to(torch.int32)
    w = torch.where(kind < 0.15, 0, torch.where(kind < 0.3, int(np.float32(2**-24).view(np.int32)), w))
    state = torch.from_numpy(key.view(np.int64)).to(dev)
    front_t = torch.from_numpy(front).to(dev)
    return (state, torch.from_numpy(changed).to(dev) & ~front_t,
            torch.where(front_t, degree, 0), w.to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["kronecker", "grid", "erdos_renyi", "hub"])
@pytest.mark.parametrize("density", [0.02, 0.6])
def test_sssp_relax_float_kernel_matches_plain(cuda, family, density):
    # the real-weight instantiation, bit for bit, zero and sub-ulp weights
    # and tied distances among its operands; twice on the card the same
    from repro_torch.core.bfs_steps import EdgeView, edge_rows, with_edge_weights
    ev, degree = weighted_graph(family, cuda)
    ev = with_edge_weights(EdgeView(ev.src, ev.dst, ev.valid, ev.num_vertices), seed=2,
                           real=True)
    state, changed, front_deg, w = real_relax_round(ev, degree, 11, density)
    rows = edge_rows(EdgeView(ev.src, ev.dst, ev.valid, ev.num_vertices, w, True), degree,
                     weighted=True)
    assert rows.weight.dtype is torch.float32      # the rows carry the weight kind
    outs = []
    for fn in (ref.sssp_relax_ref, ops.sssp_relax, ops.sssp_relax):
        st, ch = state.clone(), changed.clone()
        fn(st, ch, front_deg, rows.row_start, rows.dst, rows.weight)
        outs.append((st, ch))
    torch.cuda.synchronize()
    for st, ch in outs[1:]:
        assert torch.equal(st, outs[0][0])
        assert torch.equal(ch, outs[0][1])
    assert not torch.equal(outs[0][0], state)
    pbits, _ = ref.real_key_bits(ev.num_vertices)
    moved = outs[0][0] != state
    assert bool((((outs[0][0] & 0xFFFFFFFF) >> pbits)[moved] > 0).any())   # hops kept


@pytest.mark.cuda
def test_sssp_real_on_card_equals_cpu_and_one_launch_a_round(cuda):
    # the real-weight search through the kernel equals the plain-version run
    # bit for bit (parents too: the keys' minimum does not depend on the
    # atomics' order), one C-entry call a round
    from repro_torch.core import pipeline
    from repro_torch.core.kronecker import generate_edges
    from repro_torch.core.plan import compile_plan
    e = generate_edges(5, 12, device="cpu")
    # torch's CPU and CUDA generators give different streams: the keys are
    # sampled once, in the edge list's labels, for both devices
    keys = e.src[e.src != e.dst][:4].numpy()
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = pipeline.Graph500Config(scale=12, seed=5, kernel="sssp", heavy_threshold=None,
                                      real_weights=True, device=dev, n_roots=4)
        b = pipeline.build(cfg, edges=type(e)(e.src.to(dev), e.dst.to(dev), e.num_vertices))
        c = compile_plan(cfg.to_plan(), b, device=dev)
        roots = [int(r) for r in pipeline.search_keys(cfg, b, keys)]
        c.bfs(roots[0])
        torch.cuda.synchronize()
        before = ops.launch_counts()
        out[dev] = [c.bfs(r) for r in roots]
        torch.cuda.synchronize()
        after = ops.launch_counts()
        if dev == "cuda":
            rounds = sum(int(r.stats.levels) for r in out[dev])
            assert after["sssp_relax"] - before["sssp_relax"] == rounds > len(roots)
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a.parent, b.parent.cpu())
        assert torch.equal(a.level, b.level.cpu())
        for f in a.stats._fields:
            assert torch.equal(getattr(a.stats, f), getattr(b.stats, f).cpu()), f


# ---------------------------------------------------------------------------
# bfs_relax
# ---------------------------------------------------------------------------

def bfs_graph(core: bool, device):
    """A scale-14 Kronecker graph built on ``device`` (rows past 32 entries,
    the warp's walk): degree-sorted with a core of K = 4,096 < V, or
    neither."""
    from repro_torch.core import pipeline
    kw = dict(heavy_threshold=16) if core else dict(degree_sort=False, heavy_threshold=None)
    return pipeline.build(pipeline.Graph500Config(scale=14, seed=5, device=device, **kw))


def bfs_level_state(v, seed, density, device):
    """A level's (frontier, visited) bitmaps and parents: the frontier a
    subset of the visited set, visited vertices with a parent, the others
    at the sentinel."""
    from repro_torch.core.heavy import pack_bitmap, padded_bitmap_words
    rng = np.random.default_rng(seed)
    visited = rng.random(v) < density
    frontier = visited & (rng.random(v) < 0.5)
    parent = np.append(np.where(visited, rng.integers(0, v, v), v), v).astype(np.int32)
    w = padded_bitmap_words(v)
    return (pack_bitmap(torch.from_numpy(frontier), w).to(device),
            pack_bitmap(torch.from_numpy(visited), w).to(device),
            torch.from_numpy(parent).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("core", [False, True])
@pytest.mark.parametrize("bottom_up", [False, True])
@pytest.mark.parametrize("density", [0.02, 0.6])
def test_bfs_relax_kernel_matches_plain(cuda, core, bottom_up, density):
    # parents bit for bit (a minimum, whatever the atomics' order; the walk
    # stops at the least frontier neighbour) and the entries the bottom-up
    # read equal to the plain version's count; twice on the card alike
    from repro_torch.core.bfs_steps import edge_rows
    from repro_torch.core.hybrid_bfs import _core_bottom_up_resident
    b = bfs_graph(core, cuda)
    v = b.n_vertices
    rows = edge_rows(b.ev, b.degree, b.core)
    assert int(b.degree.max()) > 32 and (b.core is None or b.core.k < v)
    f_bm, vis_bm, parent = bfs_level_state(v, 3, density, cuda)
    before = parent.clone()
    if bottom_up and b.core is not None:
        _core_bottom_up_resident(b.core, f_bm, vis_bm, parent)
    outs = []
    for fn in ("plain", "kernel", "kernel"):
        p, read = parent.clone(), torch.zeros((), dtype=torch.int64, device=cuda)
        if bottom_up:
            (ref.bfs_relax_bottom_up_ref if fn == "plain" else ops.bfs_relax_bottom_up)(
                f_bm, p, b.degree, rows.row_start, rows.dst, rows.core_deg, read)
        else:
            (ref.bfs_relax_top_down_ref if fn == "plain" else ops.bfs_relax_top_down)(
                f_bm, vis_bm, b.degree, rows.row_start, rows.dst, p)
        outs.append((p, read))
    torch.cuda.synchronize()
    for p, read in outs[1:]:
        assert torch.equal(p, outs[0][0])
        assert int(read) == int(outs[0][1])
    assert not torch.equal(outs[0][0], before)       # the level found someone
    assert (int(outs[0][1]) > 0) == bottom_up


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["pre-g500", "no-core"])
def test_bfs_relax_one_launch_a_level(cuda, rung):
    from repro_torch.core import pipeline
    from repro_torch.core.hybrid_bfs import BOTTOM_UP
    from repro_torch.core.plan import compile_plan
    cfg = (pipeline.Graph500Config.ladder("pre-g500", scale=14, seed=5, device=cuda)
           if rung == "pre-g500"
           else pipeline.Graph500Config(scale=14, seed=5, heavy_threshold=None, device=cuda))
    built = pipeline.build(cfg)
    c = compile_plan(cfg.to_plan(), built, device=cuda)
    for key in pipeline.search_keys(cfg, built)[:3]:
        before = ops.launch_counts()
        res = c.bfs(int(key))
        torch.cuda.synchronize()
        after = ops.launch_counts()
        levels = int(res.stats.levels)
        n_bu = int((res.stats.direction[:levels] == BOTTOM_UP).sum())
        assert 0 < n_bu < levels
        # the core step runs on the bottom-up levels that begin with a core
        # row unvisited (K = 4,096 < V here)
        n_core = (core_steps(res, min(built.core.k, built.n_vertices))[1]
                  if rung == "pre-g500" else 0)
        assert {k: after[k] - before[k] for k in after} == {
            "frontier_update": levels, "core_spmv": n_core, "spmv_mxu": 0, "cin_layer": 0,
            "sssp_relax": 0, "bfs_relax": levels, "bfs_level_delta": levels,
            "bfs_level_stats": levels, "bfs_live_chunks": levels - n_bu,
            "bfs_core_merge": n_core}


@pytest.mark.cuda
def test_bfs_counters_read_only_while_a_profiler_records(cuda):
    # untraced: no counter, and the bottom-up relax is given none to add to;
    # traced: the card's counts equal the plain version's on the CPU
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.core import hybrid_bfs, pipeline
    from repro_torch.core.kronecker import EdgeList, generate_edges
    from repro_torch.core.plan import compile_plan
    e = generate_edges(5, 13, device="cpu")
    keys = e.src[e.src != e.dst][:2].numpy()
    seen, counts = [], {}
    real = hybrid_bfs.kops.bfs_relax_bottom_up

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    for dev in ("cpu", "cuda"):
        cfg = pipeline.Graph500Config(scale=13, heavy_threshold=None, device=dev)
        built = pipeline.build(cfg, edges=EdgeList(e.src.to(dev), e.dst.to(dev),
                                                   e.num_vertices))
        c = compile_plan(cfg.to_plan(), built, device=dev)
        roots = [int(r) for r in pipeline.search_keys(cfg, built, keys)]
        hybrid_bfs.kops.bfs_relax_bottom_up = spy
        try:
            tracing.reset()
            seen.clear()
            for r in roots:
                c.bfs(r)
            assert seen and all(x is None for x in seen)
            assert tracing.counters() == {}
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                         if dev == "cuda" else [ProfilerActivity.CPU]):
                for r in roots:
                    c.bfs(r)
            torch.cuda.synchronize()
        finally:
            hybrid_bfs.kops.bfs_relax_bottom_up = real
        counts[dev] = tracing.counters()
    assert counts["cuda"] == counts["cpu"]
    assert 0 < counts["cuda"]["bfs.bu_entries_read"] < counts["cuda"]["bfs.bu_entries_unvisited"]


# ---------------------------------------------------------------------------
# The level's bookkeeping (bfs_level): each kernel bit for bit against its
# plain version on the CPU, every launch checked and synchronised
# ---------------------------------------------------------------------------

def level_case(v, seed, *, empty=False):
    """A bitmap BFS level on the CPU: (parent_ext after the relax, visited
    bitmap, degree, level): visited holds exactly the vertices with a parent
    before the relax, which gave parents to some others (none when
    ``empty``), vertex 31 among them (bit 31 of word 0); the degrees large
    enough that their sums wrap modulo 2^32."""
    from repro_torch.core.heavy import pack_bitmap, padded_bitmap_words
    rng = np.random.default_rng(seed)
    visited = rng.random(v) < 0.3
    newly = ~visited & (rng.random(v) < 0.2) & (not empty)
    if not empty:
        visited[31], newly[31] = False, True
    parent = np.append(np.where(visited, rng.integers(0, v, v), v), v).astype(np.int32)
    parent[:v][newly] = rng.integers(0, v, int(newly.sum()))
    level = np.where(visited, rng.integers(0, 9, v), -1).astype(np.int32)
    return (torch.from_numpy(parent),
            pack_bitmap(torch.from_numpy(visited), padded_bitmap_words(v)),
            torch.from_numpy(rng.integers(0, 2**31 - 1, v).astype(np.int32)),
            torch.from_numpy(level))


def on(device, *ts):
    """Copies of ``ts`` on ``device`` (each run writes its own)."""
    return [t.to(device, copy=True) for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("v,empty", [(2**16, False), (2**16 + 17, False), (1000, False),
                                     (2**16, True)])
def test_level_delta_kernel_matches_plain(cuda, v, empty):
    parent, vis, degree, level = level_case(v, v, empty=empty)
    w = vis.shape[0]
    outs = []
    for dev in ("cpu", cuda, cuda):           # twice on the card: the ticket resets
        p, b, d, lv = on(dev, parent, vis, degree, level)
        found = torch.full((w,), -7, dtype=torch.int32, device=dev)
        acc = torch.full((ref.ACC_SLOTS,), 99, dtype=torch.int32, device=dev)
        ops.bfs_level_delta(p, b, d, lv, 6, found, acc)
        if dev != "cpu":
            torch.cuda.synchronize()
        outs.append([t.cpu() for t in (found, lv, acc, p)])
    for got in outs[1:]:
        for g, want in zip(got, outs[0]):
            assert torch.equal(g, want)
    assert (int(outs[0][2][ref.ACC_FOUND]) == 0) == empty
    assert empty or int(outs[0][0][0]) < 0     # bit 31 of word 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_words", [2048, 77, 131072])
@pytest.mark.parametrize("bottom_up", [False, True])
@pytest.mark.parametrize("case", ["clean", "overlap", "miscount"])
def test_level_stats_kernel_matches_plain(cuda, n_words, bottom_up, case):
    rng = np.random.default_rng(n_words + bottom_up)
    visited = to_t(rand_u32(rng, (n_words,), 0.4), "cpu")
    found = to_t(rand_u32(rng, (n_words,), 0.05), "cpu") & ~visited
    nxt, _, count = ref.frontier_update_ref(found, visited)
    if case == "overlap":
        nxt[n_words // 2] |= visited[n_words // 2] | 1
        visited[n_words // 2] |= 1
    if case == "miscount":
        count = count + 1
    acc = torch.tensor([int(x) for x in rng.integers(-2**31, 2**31, 4)]
                       + [int(ref.popcount_u32(found).sum()), 0], dtype=torch.int32)
    outs = []
    for dev in ("cpu", cuda, cuda):
        n, b, c, a = on(dev, nxt, visited, count, acc)
        stats = torch.full((ref.STATS_ROWS, 64), -1, dtype=torch.int32, device=dev)
        stats[ref.STATS_FS:ref.STATS_SE + 1].zero_()
        for lvl in (0, 63):                   # every level reads the acc the last left
            ops.bfs_level_stats(n, b, c, a, stats, lvl, bottom_up, 2**31 - 1 - lvl, 64)
            if dev != "cpu":
                torch.cuda.synchronize()
        outs.append((stats.cpu(), a.cpu()))
    for got in outs[1:]:
        assert torch.equal(got[0], outs[0][0]) and torch.equal(got[1], outs[0][1])
    assert int(outs[0][0][ref.STATS_OK, 0]) == {"clean": 7, "overlap": 5, "miscount": 6}[case]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "scale14"])
def test_level_stats_core_count_matches_plain(cuda, case):
    # the core rows left unvisited, which the level reads back beside the
    # frontier's size: on random bitmaps for bounds below, at and past V
    # (the engine passes min(K, V)) and no multiple of 32, and on every
    # level of scale-14 searches, where it decides which core steps run
    from repro_torch.core import hybrid_bfs, pipeline
    from repro_torch.core.plan import compile_plan
    calls = []
    if case == "random":
        rng = np.random.default_rng(14)
        for n_words, core_rows in [(2048, 4096), (2048, 65536), (2048, 1000 + 17),
                                   (131072, 200_704), (77, 77 * 32), (77, 0)]:
            visited = to_t(rand_u32(rng, (n_words,), 0.6), "cpu")
            found = to_t(rand_u32(rng, (n_words,), 0.3), "cpu") & ~visited
            nxt, _, count = ref.frontier_update_ref(found, visited)
            calls.append((nxt, visited, count, core_rows))
    else:
        cfg = pipeline.Graph500Config.ladder("pre-g500", scale=14, seed=5, device=cuda)
        built = pipeline.build(cfg)
        c = compile_plan(cfg.to_plan(), built, device=cuda)
        real = hybrid_bfs.kops.bfs_level_stats

        def keep(nxt, visited, count, *rest):
            calls.append((nxt.cpu(), visited.cpu(), count.cpu(), rest[-2]))
            return real(nxt, visited, count, *rest)

        hybrid_bfs.kops.bfs_level_stats = keep
        try:
            keys = pipeline.search_keys(cfg, built)[:3]
            for key in keys:
                c.bfs(int(key))
            torch.cuda.synchronize()
        finally:
            hybrid_bfs.kops.bfs_level_stats = real
        assert all(rows == min(built.core.k, built.n_vertices) for *_, rows in calls)
    counts = []
    for nxt, visited, count, core_rows in calls:
        got = []
        for dev in ("cpu", cuda, cuda):
            n, b, cnt = on(dev, nxt, visited, count)
            acc = torch.tensor([0, 0, 0, 0, int(count), 0], dtype=torch.int32, device=dev)
            stats = torch.full((ref.STATS_ROWS, 4), -1, dtype=torch.int32, device=dev)
            unvisited = torch.full((), -9, dtype=torch.int32, device=dev)
            ops.bfs_level_stats(n, b, cnt, acc, stats, 1, True, 5, 64, core_rows, unvisited)
            if dev != "cpu":
                torch.cuda.synchronize()
            got.append(int(unvisited))
        assert got[1] == got[2] == got[0] >= 0
        counts.append(got[0])
    assert len(counts) >= 6 and 0 in counts and any(counts)


@pytest.mark.cuda
@pytest.mark.parametrize("n_chunks", [1, 64, 300])
@pytest.mark.parametrize("density", [0.0001, 0.01, 0.5])
def test_live_chunks_kernel_matches_plain(cuda, n_chunks, density):
    from repro_torch.core import pipeline
    from repro_torch.core.bfs_steps import edge_rows
    from repro_torch.core.heavy import padded_bitmap_words
    b = pipeline.build(pipeline.Graph500Config.ladder("pre-g500", scale=16, seed=5,
                                                      device="cpu"))
    rows = edge_rows(b.ev, b.degree, b.core, n_chunks)
    w = padded_bitmap_words(b.n_vertices)
    rng = np.random.default_rng(n_chunks)
    ranges = [(rows.src_lo, rows.src_hi),
              # empty chunks, ranges past either end, one word wide
              (torch.tensor([0, 5, 40, 2**31 - 1, -100, 31, 70000], dtype=torch.int32),
               torch.tensor([-1, 60000, 40, 2**31 - 1, 70, 32, 10**6], dtype=torch.int32))]
    for lo, hi in ranges:
        frontier = to_t(rand_u32(rng, (w,), density), "cpu")
        outs = []
        for dev in ("cpu", cuda, cuda):
            f, l, h = on(dev, frontier, lo, hi)
            stats = torch.full((ref.STATS_ROWS, 4), -1, dtype=torch.int32, device=dev)
            ops.bfs_live_chunks(f, l, h, stats, 1)
            if dev != "cpu":
                torch.cuda.synchronize()
            outs.append(stats.cpu())
        assert all(torch.equal(o, outs[0]) for o in outs[1:])
        assert int(outs[0][ref.STATS_CH, 1]) == int(ref.chunk_range_mask(lo, hi, frontier).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("k,v", [(4096, 1000), (4096, 2**16 + 17), (61440, 2**22)])
def test_core_merge_kernel_matches_plain(cuda, k, v):
    # a core larger than V, smaller with V % 32 != 0, and the scale-22 cell's
    parent, vis, _, _ = level_case(v, k)
    rng = np.random.default_rng(k + v)
    cand = torch.from_numpy(np.where(rng.random(k) < 0.4, ref.BIG,
                                     rng.integers(0, v, k)).astype(np.int32))
    outs = []
    for dev in ("cpu", cuda):
        c, b, p = on(dev, cand, vis, parent)
        ops.bfs_core_merge(c, b, p)
        if dev != "cpu":
            torch.cuda.synchronize()
        outs.append(p.cpu())
    assert torch.equal(outs[1], outs[0]) and not torch.equal(outs[0], parent)


@pytest.mark.cuda
def test_core_step_past_2_31_words(cuda):
    # a core of K = 266,240 rows (2.2e9 words, 8.9 GB), so word offsets pass
    # 2^31; only its last 64 rows carry bits.  core_spmv answers BIG on every
    # other row, reading it whole, and on the last rows what the plain
    # version answers on them alone; the merge of those answers equals the
    # plain merge
    k, n = 266_240, 64
    w = k // 32
    assert k * w > 2**31
    rng = np.random.default_rng(17)
    a = torch.zeros((k, w), dtype=torch.int32, device=cuda)
    a[-n:] = to_t(rand_u32(rng, (n, w), 0.0005), cuda)
    f = to_t(rand_u32(rng, (w,), 0.005), cuda)
    words = torch.zeros((), dtype=torch.int64, device=cuda)
    got = frontier_spmv.core_spmv(a, f, words_read=words)
    tail = ref.core_spmv_ref(a[-n:], f)
    assert 0 < int((tail < ref.BIG).sum()) < n       # rows that hit and rows that do not
    assert torch.equal(got[-n:], tail) and bool((got[:-n] == ref.BIG).all())
    assert int(words) == (k - n) * w + int(ref.core_words_read(tail, w))
    del a
    v = k + 1000
    vis = to_t(rand_u32(rng, (-(-v // 32),), 0.3), cuda)
    parent = torch.from_numpy(np.where(rng.random(v + 1) < 0.5, v,
                                       rng.integers(0, v, v + 1)).astype(np.int32)).to(cuda)
    parent[-1] = v
    before = parent.cpu()
    want = before.clone()
    ref.bfs_core_merge_ref(got.cpu(), vis.cpu(), want)
    ops.bfs_core_merge(got, vis, parent)
    torch.cuda.synchronize()
    assert torch.equal(parent.cpu(), want) and not torch.equal(want, before)


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["pre-g500", "no-core", "v5000"])
def test_bitmap_search_on_card_equals_cpu(cuda, graph):
    # whole searches through every kernel of the level loop: parent, level
    # and all seven stats fields bit for bit against the plain versions on
    # the CPU, both directions run
    from repro_torch.core import pipeline
    from repro_torch.core.hybrid_bfs import BOTTOM_UP
    from repro_torch.core.kronecker import EdgeList, generate_edges
    from repro_torch.core.plan import compile_plan
    scale = 13 if graph == "v5000" else 16
    e = generate_edges(5, scale, device="cpu")
    v = 5000 if graph == "v5000" else e.num_vertices
    src, dst = e.src % v, e.dst % v
    keys = src[src != dst][:3].numpy()
    runs = []
    for dev in ("cpu", cuda):
        cfg = (pipeline.Graph500Config(scale=scale, heavy_threshold=None, n_roots=3, device=dev)
               if graph == "no-core"
               else pipeline.Graph500Config.ladder("pre-g500", scale=scale, n_roots=3,
                                                   device=dev))
        built = pipeline.build(cfg, edges=EdgeList(src.to(dev), dst.to(dev), v))
        c = compile_plan(cfg.to_plan(), built, device=dev)
        roots = pipeline.search_keys(cfg, built, keys)
        runs.append([c.bfs(int(r)) for r in roots])
        torch.cuda.synchronize()
    for got, want in zip(runs[1], runs[0]):
        assert torch.equal(got.parent.cpu(), want.parent)
        assert torch.equal(got.level.cpu(), want.level)
        for f in want.stats._fields:
            assert torch.equal(getattr(got.stats, f).cpu(), getattr(want.stats, f)), f
        n = int(want.stats.levels)
        assert set(want.stats.direction[:n].tolist()) == {0, BOTTOM_UP}


# ---------------------------------------------------------------------------
# spmv_mxu and cin_layer
# ---------------------------------------------------------------------------

def int8_operands(rng, k, r, full_range):
    lo, hi = (-128, 128) if full_range else (0, 2)
    return (rng.integers(lo, hi, (k, k)).astype(np.int8),
            rng.integers(lo, hi, (k, r)).astype(np.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("k,r", [(128, 128), (512, 256), (1024, 128)])
def test_spmv_mxu_kernel_matches_plain(cuda, k, r, full_range):
    rng = np.random.default_rng(k + r)
    a, f = (torch.from_numpy(x).to(cuda) for x in int8_operands(rng, k, r, full_range))
    got = spmv_mxu.spmv_mxu(a, f)
    assert got.dtype == torch.int32 and torch.equal(got, ref.spmv_mxu_ref(a, f))


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["bool", "full", "neg128"])
@pytest.mark.parametrize("k,r", [(128, 128), (384, 128), (1024, 256), (4224, 128)])
def test_spmv_mxu_stream_k_shapes(cuda, k, r, values):
    # (128, 128): one tile, fewer than the SMs; (384, 128): a ragged row
    # tile; (1024, 256): two frontier tiles; (4224, 128): split tiles
    rng = np.random.default_rng(k * 7 + r)
    if values == "neg128":
        a = torch.full((k, k), -128, dtype=torch.int8, device=cuda)
        f = torch.full((k, r), -128, dtype=torch.int8, device=cuda)
    else:
        a, f = (torch.from_numpy(x).to(cuda)
                for x in int8_operands(rng, k, r, values == "full"))
    got = spmv_mxu.spmv_mxu(a, f)
    assert torch.equal(got, ref.spmv_mxu_ref(a, f))
    if values == "neg128":
        assert int(got.min()) == int(got.max()) == k * 128 * 128
    if k == 4224:
        assert spmv_mxu.spmv_plan(k, r, spmv_mxu.sm_count(cuda)).split_tiles


@pytest.mark.cuda
def test_spmv_mxu_back_to_back_identical(cuda):
    # split tiles are summed with integer atomics: any order, same bits
    rng = np.random.default_rng(9)
    a, f = (torch.from_numpy(x).to(cuda) for x in int8_operands(rng, 4224, 256, True))
    first = spmv_mxu.spmv_mxu(a, f)
    second = spmv_mxu.spmv_mxu(a, f)
    assert torch.equal(first, second)
    assert torch.equal(first, torch._int_mm(a, f))


@pytest.mark.cuda
def test_spmv_mxu_kernel_bit7_extreme(cuda):
    # every term (-128) * (-128): the int32 sum K * 2^14, sign bit of int8 set
    k = 1024
    a = torch.full((k, k), -128, dtype=torch.int8, device=cuda)
    f = torch.full((k, 128), -128, dtype=torch.int8, device=cuda)
    f[:, 1] = 127
    got = spmv_mxu.spmv_mxu(a, f)
    assert int(got[:, 0].min()) == int(got[:, 0].max()) == k * 128 * 128
    assert int(got[:, 1].max()) == -k * 128 * 127
    assert torch.equal(got, ref.spmv_mxu_ref(a, f))


def cin_operands(rng, b, f0, fl, h, d, device):
    return (torch.from_numpy(rng.normal(size=(b, f0, d)).astype(np.float32)).to(device),
            torch.from_numpy(rng.normal(size=(b, fl, d)).astype(np.float32)).to(device),
            torch.from_numpy((rng.normal(size=(h, f0, fl)) / np.sqrt(f0 * fl))
                             .astype(np.float32)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("b,f0,fl,h,d", [
    (512, 39, 39, 200, 10), (512, 39, 200, 200, 10), (300, 39, 200, 200, 10),
    (1, 39, 200, 200, 10), (128, 8, 8, 16, 4), (77, 5, 3, 70, 3),
    # K split over blocks with a ragged last row tile (B = 513), over many
    # blocks at B = 7; D = 3 and 4 with H = 70 (one 128-wide tile)
    (513, 39, 200, 200, 10), (7, 39, 39, 200, 10), (96, 12, 20, 70, 3),
    (100, 12, 20, 70, 4),
    # Fl = 400: 400 K units; F0 = 150: four chunks of i
    (256, 6, 400, 40, 10), (8192, 150, 20, 30, 4),
    # H = 300: two 200-wide filter tiles
    (40, 5, 8, 300, 4)])
def test_cin_layer_kernel_matches_plain(cuda, b, f0, fl, h, d):
    # 3xTF32 on the tensor cores against the fp32 oracle (TF32 off):
    # rtol = atol = 2e-4
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(b + fl)
    x0, xl, w = cin_operands(rng, b, f0, fl, h, d, cuda)
    got = cin.cin_layer(x0, xl, w)
    assert got.shape == (b, h, d)
    torch.testing.assert_close(got, ref.cin_layer_ref(x0, xl, w), rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,f0,fl,h,d,splits", [
    # B * D not a multiple of 64: a row tile ends inside a warpgroup
    (13, 39, 39, 200, 10, None), (1000, 39, 200, 200, 7, None),
    # the narrowest and the widest wgmma tile (H = 8 pads to 16)
    (64, 6, 10, 8, 4, None), (96, 7, 9, 256, 5, None),
    # Fl = 1: one k8 step a unit; F0 = 1: one i block of 8, seven of them padding
    (200, 11, 1, 40, 10, None), (50, 1, 24, 32, 10, None),
    # K units split unevenly, with split boundaries inside a TMA box
    (300, 39, 37, 70, 3, 7), (512, 39, 200, 200, 10, 7),
    # several i chunks split across blocks
    (128, 150, 20, 30, 4, 3)])
def test_cin_layer_kernel_tile_edges(cuda, b, f0, fl, h, d, splits):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(b * 7 + fl)
    x0, xl, w = cin_operands(rng, b, f0, fl, h, d, cuda)
    got = cin.cin_layer(x0, xl, w, splits=splits)
    assert got.shape == (b, h, d)
    torch.testing.assert_close(got, ref.cin_layer_ref(x0, xl, w), rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("f0,fl,h", [(39, 200, 200), (39, 39, 200), (150, 20, 30),
                                     (5, 8, 300), (3, 1, 8)])
def test_cin_prep_matches_weight_layout(cuda, f0, fl, h):
    # the prep launch's w_hi / w_lo equal the plain layout bit for bit
    w = cin_operands(np.random.default_rng(h), 1, f0, fl, h, 1, cuda)[2]
    plan = cin.cin_plan(1, f0, fl, h, 1)
    assert torch.equal(cin.prep_weights(w).cpu(), cin.weight_layout(w.cpu(), plan))


@pytest.mark.cuda
def test_cin_layer_split_path_is_deterministic(cuda):
    # B = 512 splits K over blocks; the partials are summed in a fixed
    # order, so two calls give the same bits
    assert cin.cin_plan(512, 39, 200, 200, 10).splits > 1
    x0, xl, w = cin_operands(np.random.default_rng(11), 512, 39, 200, 200, 10, cuda)
    first = cin.cin_layer(x0, xl, w)
    second = cin.cin_layer(x0, xl, w)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_new_kernel_wrappers_refuse_bad_inputs(cuda):
    a8 = torch.zeros((128, 128), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="int8"):
        spmv_mxu.spmv_mxu(a8.to(torch.int32), a8)
    with pytest.raises(ValueError, match="contiguous"):
        spmv_mxu.spmv_mxu(torch.zeros((128, 256), dtype=torch.int8, device=cuda)[:, ::2], a8)
    with pytest.raises(ValueError, match="multiples of 128"):
        spmv_mxu.spmv_mxu(a8[:64, :64].contiguous(), a8[:64].contiguous())
    x = torch.zeros((4, 3, 2), device=cuda)
    w = torch.zeros((5, 3, 3), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        cin.cin_layer(x.double(), x, w)
    with pytest.raises(ValueError, match="contiguous"):
        cin.cin_layer(torch.zeros((4, 2, 3), device=cuda).transpose(1, 2), x, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cin.cin_layer(x, x.cpu(), w)
    with pytest.raises(ValueError, match="no backward"):
        cin.cin_layer(x, x, w.clone().requires_grad_())


@pytest.mark.cuda
@pytest.mark.parametrize("use_cin_kernel", [False, True])
def test_xdeepfm_serve_on_card_matches_cpu(cuda, use_cin_kernel):
    from repro_torch.configs import get
    from repro_torch.models import recsys
    from repro_torch.train import train_step as ts
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get("xdeepfm").make_smoke_config(),
                              use_cin_kernel=use_cin_kernel)
    params = recsys.init_params(cfg, seed=0, device="cpu")
    # the table at 0.3, not init's 0.01, so the CIN layers are O(0.01-0.1)
    # and a wrong kernel shows in the probabilities and the features
    params["table"].mul_(30.0)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.rows_per_field, (300, cfg.n_sparse)).astype(np.int32))
    want = ts.make_xdeepfm_serve_step(cfg)(params, ids)
    with torch.inference_mode():
        feat = recsys.cin_features(params, recsys.embed(params, ids, cfg)[1], cfg)
    assert float(feat.abs().max()) > 1e-2
    params = {k: v.to(cuda) for k, v in params.items()}
    got = ts.make_xdeepfm_serve_step(cfg)(params, ids.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    with torch.inference_mode():
        got_feat = recsys.cin_features(params, recsys.embed(params, ids.to(cuda), cfg)[1],
                                       cfg)
    torch.testing.assert_close(got_feat.cpu(), feat, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# Checked execution and serving on the card
# ---------------------------------------------------------------------------

def _scale12_on_both(cuda):
    """The same scale-12 edge list built on the CPU and on the card, with
    its search keys (in the edge list's labels) and built graphs."""
    from repro_torch.core import pipeline
    from repro_torch.core.kronecker import EdgeList, generate_edges
    e = generate_edges(5, 12, device="cpu")
    keys = e.src[e.src != e.dst][:4].numpy()
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = pipeline.Graph500Config.ladder("pre-g500-batch", scale=12, n_roots=4,
                                             device=dev)
        built = pipeline.build(cfg, edges=EdgeList(e.src.to(dev), e.dst.to(dev),
                                                   e.num_vertices))
        out[dev] = (cfg, built, pipeline.search_keys(cfg, built, keys))
    return out


@pytest.mark.cuda
def test_serving_on_card_equals_offline_and_cpu(cuda):
    # a Zipf trace served through the engine on the card: every answer, hit
    # or miss, equals the offline run, and the card's serving equals the CPU's
    from repro_torch.core import pipeline
    from repro_torch.data.query_trace import synth_trace
    from repro_torch.serve.engine import ServeConfig
    reports = []
    for dev, (cfg, built, _) in _scale12_on_both(cuda).items():
        _, eng = pipeline.serve(cfg, ServeConfig(batch_size=4, max_wait_s=0.01,
                                                 cache_capacity=16), built=built)
        assert eng.compiled.device.type == dev
        trace = synth_trace(7, 24, built.n_vertices, rate_qps=50.0, zipf_s=1.3,
                            degree=built.degree)
        before = ops.launch_counts()
        report = eng.serve(trace)
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
        if dev == "cuda":
            assert launched["frontier_update"] > 0 and launched["core_spmv"] > 0
        assert all(a.kind != "failed" for a in report.answers)
        uniq = sorted({a.root for a in report.answers})
        res = eng.compiled.run(np.asarray(uniq), warmup=False, check="post")
        assert res.run.all_valid
        idx = {r: i for i, r in enumerate(uniq)}
        for a in report.answers:
            np.testing.assert_array_equal(a.parent, res.parent[idx[a.root]])
            np.testing.assert_array_equal(a.level, res.level[idx[a.root]])
        reports.append({a.root: a.parent for a in report.answers})
    assert reports[0].keys() == reports[1].keys()
    for r in reports[0]:
        np.testing.assert_array_equal(reports[0][r], reports[1][r])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [True, False])
def test_parent_fault_quarantined_on_card(cuda, batch):
    # a persistent parent fault on one root: detected, retried, quarantined
    # (the per-root plan also falls back once); the other rows are clean
    from repro_torch.core.faults import FaultSpec
    from repro_torch.core.plan import compile_plan
    cfg, built, roots = _scale12_on_both(cuda)["cuda"]
    plan = dataclasses.replace(cfg.to_plan(), batch_roots=batch)
    bad = int(roots[1])
    fault = FaultSpec("parent", "self", level=1, persistent=True, root=bad)
    run = compile_plan(plan, built, fault=fault).run(roots, check="full", retries=1,
                                                      fallback=True)
    clean = compile_plan(plan, built).run(roots, check="full")
    assert clean.run.all_valid
    g = run.run
    assert set(g.check_failures) == {bad} and "depth" in g.check_failures[bad]
    assert (g.retries, g.fallbacks) == (1, 0 if batch else 1)
    assert g.quarantined == [bad] and g.teps[1] == 0.0
    assert g.validated == [True, False, True, True]
    keep = [0, 2, 3]
    np.testing.assert_array_equal(run.parent[keep], clean.parent[keep])
    assert not np.array_equal(run.parent[1], clean.parent[1])


@pytest.mark.cuda
def test_tune_sweep_on_card_identical_winner(cuda, tmp_path):
    # a scale-10 small sweep on the card: backend "cuda", the one candidate
    # accepted bitwise against the oracle, both kernels launched, and the
    # saved winner read back under the card's key
    from repro_torch.core import tune
    before = ops.launch_counts()
    rep = tune.sweep(10, budget="small", n_roots=4, reps=1, log=lambda s: None)
    launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
    assert (rep.backend, rep.n_devices, rep.interpret_mode) == (
        "cuda", torch.cuda.device_count(), False)
    assert rep.winner is not None and rep.winner.identical
    assert rep.winner.per_root_us > 0 and rep.winner.harmonic_mean_teps > 0
    assert launched["frontier_update"] > 0 and launched["core_spmv"] > 0
    path = tune.save_tuned(rep, str(tmp_path / "t.json"))
    got = tune.tuned_plan(10, path=path)
    assert got == rep.winner.plan


# ---------------------------------------------------------------------------
# The multi-device layouts on virtual meshes of the card
# ---------------------------------------------------------------------------

_CARD_CACHE: dict = {}


def _scale17_on_card(cuda):
    from repro_torch.core import pipeline
    if "s17" not in _CARD_CACHE:
        cfg = pipeline.Graph500Config.ladder("pre-g500-batch", scale=17, n_roots=3)
        built = pipeline.build(cfg)
        _CARD_CACHE["s17"] = (cfg, built, pipeline.search_keys(cfg, built))
    return _CARD_CACHE["s17"]


@pytest.mark.cuda
@pytest.mark.parametrize("partition", ["block", "word_cyclic"])
def test_vertex_sharded_on_card_equals_single_device(cuda, partition):
    # scale 17 over (2, 2): W_loc = 1024, so the epilogue launches
    # frontier_update on every shard, and core_spmv runs on each
    from repro_torch.comms.mesh import make_mesh
    from repro_torch.core.plan import BFSPlan, compile_plan
    cfg, built, roots = _scale17_on_card(cuda)
    base = compile_plan(cfg.to_plan(), built).run(roots, check="off")
    c = compile_plan(BFSPlan(layout=("group", "member"), partition=partition), built,
                     mesh=make_mesh((2, 2), ("group", "member"), virtual=True))
    assert c.graph.sharded.w_loc == 1024
    before = ops.launch_counts()
    res = c.run(roots, check="full")
    launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
    assert res.run.all_valid and not any(res.run.check_counts.values())
    np.testing.assert_array_equal(res.parent, base.parent)
    np.testing.assert_array_equal(res.level, base.level)
    assert launched["frontier_update"] > 0 and launched["core_spmv"] > 0


@pytest.mark.cuda
def test_root_layout_on_card_equals_single_device(cuda):
    from repro_torch.comms.mesh import make_mesh
    from repro_torch.core.plan import BFSPlan, compile_plan
    cfg, built, roots = _scale17_on_card(cuda)
    base = compile_plan(cfg.to_plan(), built).bfs(roots)
    for mesh in (None, make_mesh((2,), ("root",), virtual=True)):
        res = compile_plan(BFSPlan(layout=("root",)), built, mesh=mesh).bfs(roots)
        assert torch.equal(res.parent, base.parent) and torch.equal(res.level, base.level)


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["hier_min", "flat"])
def test_sharded_sssp_on_card_equals_single_device(cuda, exchange):
    from repro_torch.comms.mesh import make_mesh
    from repro_torch.core import pipeline
    from repro_torch.core.plan import BFSPlan, compile_plan
    cfg = pipeline.Graph500Config.ladder("pre-g500-batch", scale=14, n_roots=2,
                                         kernel="sssp")
    built = pipeline.build(cfg)
    roots = pipeline.search_keys(cfg, built)
    base = compile_plan(cfg.to_plan(), built).bfs(roots)
    c = compile_plan(BFSPlan(layout=("group", "member"), kernel="sssp",
                             exchange=exchange, partition="word_cyclic"), built,
                     mesh=make_mesh((2, 2), ("group", "member"), virtual=True))
    res = c.bfs(roots)
    v = built.n_vertices
    assert torch.equal(res.parent[:, :v], base.parent)
    assert torch.equal(res.level[:, :v], base.level)
    assert c.run(roots, check="full").run.all_valid


@pytest.mark.cuda
def test_mesh_engine_on_card_equals_offline(cuda):
    # a virtual (2, 2) engine at scale 17 (W_loc = 1024: both kernels on
    # every shard) serving a few queries: each answer equals the offline run
    from repro_torch.comms.mesh import make_mesh
    from repro_torch.core.plan import BFSPlan
    from repro_torch.data.query_trace import synth_trace
    from repro_torch.serve.engine import Engine, ServeConfig
    _, built, _ = _scale17_on_card(cuda)
    eng = Engine(built, plan=BFSPlan(layout=("group", "member"), mesh_shape=(2, 2),
                                     partition="word_cyclic"),
                 config=ServeConfig(batch_size=4, max_wait_s=0.01, cache_capacity=8),
                 mesh=make_mesh((2, 2), ("group", "member"), virtual=True))
    trace = synth_trace(7, 8, built.n_vertices, rate_qps=2000.0, zipf_s=1.1,
                        degree=built.degree)
    before = ops.launch_counts()
    report = eng.serve(trace)
    launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
    assert launched["frontier_update"] > 0 and launched["core_spmv"] > 0
    uniq = sorted({a.root for a in report.answers})
    res = eng.compiled.run(np.asarray(uniq), warmup=False, check="post")
    idx = {r: i for i, r in enumerate(uniq)}
    for a in report.answers:
        assert a.kind != "failed"
        np.testing.assert_array_equal(a.parent, res.parent[idx[a.root]])


@pytest.mark.cuda
def test_xdeepfm_train_step_on_card_matches_cpu(cuda):
    # one batch's loss and gradients from the same parameters: loss within
    # rtol 1e-5, every gradient element within rtol 1e-5 of the CPU's plus
    # 1e-5 of its leaf's largest |gradient| (float32 sums in another order;
    # TF32 off); then one AdamW step from each, parameters within atol 1e-6
    from repro_torch.configs import get
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.models import recsys
    from repro_torch.optim import AdamW, cosine
    from repro_torch.train import train_step as TS
    cfg = dataclasses.replace(get("xdeepfm").make_smoke_config(), rows_per_field=4096)
    params = recsys.init_params(cfg, seed=0, device="cpu")
    batch = recsys_batch(0, 0, 512, cfg.n_sparse, cfg.rows_per_field, device="cpu")
    opt = AdamW(cosine(1e-3, 5, 20))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", cuda):
            p = {k: v.to(dev) for k, v in params.items()}
            loss, grads = TS.xdeepfm_value_and_grad(
                p, {k: v.to(dev) for k, v in batch.items()}, cfg)
            out[str(dev)] = (loss, grads) + opt.update(grads, opt.init(p), p)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (lc, gc, pc, _), (lg, gg, pg, sg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(float(lg), float(lc), rtol=1e-5)
    for k in gc:
        want = gc[k].numpy()
        top = float(np.abs(want).max())
        np.testing.assert_allclose(gg[k].cpu().numpy(), want, rtol=1e-5, atol=1e-5 * top,
                                   err_msg=k)
    for k in pc:
        assert pg[k].device.type == "cuda"
        np.testing.assert_allclose(pg[k].cpu().numpy(), pc[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    assert int(sg.step) == 1


# ---------------------------------------------------------------------------
# The LM stack on the card against the CPU (plain torch: the LM path runs
# none of the hand-written kernels; these hold cuBLAS's bf16 products and the
# card's float32 sums against the CPU's at the JAX package's tolerances)
# ---------------------------------------------------------------------------

LM_SMOKE = ["granite-moe-1b-a400m", "minicpm-2b", "moonshot-v1-16b-a3b", "olmo-1b",
            "starcoder2-15b"]


def lm_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float().cpu() - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_SMOKE)
def test_lm_forward_and_decode_on_card_match_cpu(cuda, arch):
    # logits within 3e-2 x max |logit| and aux within 1e-3 (forward), each
    # teacher-forced decode step within 3e-2 x max |logit|
    from repro_torch.configs import get
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as T
    cfg = get(arch).make_smoke_config()
    params = T.init_params(cfg, seed=0, device="cpu")
    toks = lm_batch(0, 0, 2, 16, cfg.vocab, device="cpu")["tokens"]
    card = {k: v.to(cuda) for k, v in params.items()}
    with torch.no_grad():
        want, want_aux = T.forward(params, toks, cfg)
        got, aux = T.forward(card, toks.to(cuda), cfg)
        assert lm_rel(got, want) <= 3e-2
        assert abs(float(aux) - float(want_aux)) <= 1e-3
        cache_c = T.init_cache(cfg, 2, 16, device="cpu")
        cache_g = T.init_cache(cfg, 2, 16, device=cuda)
        for t in range(16):
            lc, _ = T.decode_step(params, cache_c, toks[:, t:t + 1], t, cfg)
            lg, _ = T.decode_step(card, cache_g, toks[:, t:t + 1].to(cuda), t, cfg)
            assert lm_rel(lg, lc) <= 3e-2, t


@pytest.mark.cuda
def test_lm_train_step_gradients_on_card_match_cpu(cuda):
    # granite-smoke: the loss within 1e-2, each gradient leaf within 3e-2 of
    # the CPU leaf's largest |gradient| (bf16), then one AdamW step each
    from repro_torch.configs import get
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW, constant
    from repro_torch.train import train_step as TS
    cfg = get("granite-moe-1b-a400m").make_smoke_config()
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = lm_batch(0, 0, 2, 16, cfg.vocab, device="cpu")
    opt = AdamW(constant(1e-3))
    lc, gc = TS.lm_value_and_grad(params, batch, cfg)
    card = {k: v.to(cuda) for k, v in params.items()}
    lg, gg = TS.lm_value_and_grad(card, {k: v.to(cuda) for k, v in batch.items()}, cfg)
    assert abs(float(lg) - float(lc)) <= 1e-2
    for k in gc:
        assert gg[k].dtype == gc[k].dtype and gg[k].device.type == "cuda"
        assert lm_rel(gg[k], gc[k]) <= 3e-2, k
    new, state = opt.update(gg, opt.init(card), card)
    assert int(state.step) == 1 and all(new[k].dtype == card[k].dtype for k in new)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The bf16 ulps between ``a`` and ``b`` (0 for two NaNs, 2^16 for one)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    d = (ordered(a) - ordered(b)).abs()
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.where(na & nb, 0, torch.where(na | nb, 1 << 16, d))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_bf16_activations_on_card_match_cpu(cuda, name):
    # XLA's bf16 op chains, forward and backward (a unit and a random
    # cotangent), over every finite bf16 input: the card within one bf16 ulp
    # of the CPU (CUDA's expf / tanhf are not the CPU's); the differing
    # inputs are counted in the assertion message
    from repro_torch.models import layers as L
    fn = {"silu": L.silu, "gelu": L.gelu}[name]
    x = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    rng = np.random.default_rng(0)
    mag = 2.0 ** rng.uniform(-8.0, 8.0, x.numel())
    g_rand = torch.from_numpy(np.where(rng.random(x.numel()) < 0.5, -mag, mag)
                              .astype(np.float32)).to(torch.bfloat16)

    def run(dev):
        xr = x.to(dev).requires_grad_()
        y = fn(xr)
        outs = [y.detach()]
        for g in (torch.ones_like(x), g_rand):
            outs += torch.autograd.grad(y, xr, g.to(dev), retain_graph=True)
        return [o.cpu() for o in outs]

    for what, got, want in zip(("forward", "grad g=1", "grad g random"), run(cuda),
                               run("cpu")):
        assert got.dtype == want.dtype == torch.bfloat16
        ulps = bf16_ulps(got, want)
        assert int(ulps.max()) <= 1, (
            f"{name} {what}: {int((ulps > 0).sum())} of {x.numel()} inputs differ, "
            f"at most {int(ulps.max())} ulps")


# ---------------------------------------------------------------------------
# The GNN stack on the card (it launches none of the kernels above: its
# products are torch matmuls and its segment sums index_add, as the JAX
# package's are plain jnp)
# ---------------------------------------------------------------------------

class _CaptureGrads:
    """An optimizer whose update hands back the gradients as the state."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        return params, grads


def _gnn_smoke(arch, device):
    from repro_torch.configs import get
    from repro_torch.data.graphs import make_feature_graph, make_molecule_batch
    from repro_torch.models import gnn
    from repro_torch.train import train_step as TS
    cfg = get(arch).make_smoke_config()
    if arch in ("gat-cora", "graphsage-reddit"):
        g, y = make_feature_graph(0, 7, d_feat=cfg.d_in, n_classes=cfg.n_classes,
                                  edge_factor=4, device="cpu")
        kind = "gat" if arch == "gat-cora" else "sage"
        fwd = gnn.gat_forward if kind == "gat" else gnn.sage_forward
        return (cfg, lambda p, g, y: fwd(p, g, cfg),
                TS.make_gnn_train_step(kind, cfg, _CaptureGrads()),
                lambda d: (g.to(d), y.to(d)))
    g, sp, tri = make_molecule_batch(0, 4, 8, 16, device="cpu")
    if arch == "dimenet":
        tgt = torch.linspace(-1.0, 1.0, 4)
        return (cfg, lambda p, g, s, t, y: gnn.dimenet_energy(p, g, s, t, cfg, 4),
                TS.make_dimenet_train_step(cfg, _CaptureGrads(), 4),
                lambda d: (g.to(d), sp.to(d), {k: v.to(d) for k, v in tri.items()},
                           tgt.to(d)))
    tgt = torch.linspace(-1.0, 1.0, g.n_nodes)
    return (cfg, lambda p, g, s, y: gnn.equiformer_forward(p, g, s, cfg),
            TS.make_equiformer_train_step(cfg, _CaptureGrads()),
            lambda d: (g.to(d), sp.to(d), tgt.to(d)))


def _scaled(got, want):
    want = want.detach().float().cpu()
    return float((got.detach().float().cpu() - want).abs().max() /
                 want.abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gat-cora", "graphsage-reddit", "dimenet", "equiformer-v2"])
def test_gnn_forward_and_train_step_on_card_match_cpu(cuda, arch):
    # float32 throughout with TF32 off; the card's segment sums are atomic,
    # so the sums run in another order: forwards within 1e-5 x max |out|,
    # the loss within 1e-4, each gradient within 1e-5 x its leaf's max
    from repro_torch.kernels import ops
    from repro_torch.models import gnn
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, fwd, step, args = _gnn_smoke(arch, cuda)
        params = gnn.INITS[arch](cfg, seed=0, device="cpu")
        card = {k: v.to(cuda) for k, v in params.items()}
        before = ops.launch_counts()
        with torch.no_grad():
            assert _scaled(fwd(card, *args(cuda)), fwd(params, *args("cpu"))) <= 1e-5
        _, gc, lc = step(params, None, *args("cpu"))
        _, gg, lg = step(card, None, *args(cuda))
        assert ops.launch_counts() == before
        assert abs(float(lg) - float(lc)) <= 1e-4
        for k in gc:
            assert gg[k].device.type == "cuda" and _scaled(gg[k], gc[k]) <= 1e-5, k
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


@pytest.mark.cuda
def test_gnn_owner_partitioned_step_on_card_matches_single_device(cuda):
    from repro_torch.comms.mesh import make_mesh
    from repro_torch.models import gnn, gnn_dist
    from repro_torch.optim import AdamW, constant
    from repro_torch.train import train_step as TS
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, _, _, args = _gnn_smoke("graphsage-reddit", cuda)
        g, y = args(cuda)
        params = gnn.sage_init(cfg, seed=0, device=cuda)
        opt = AdamW(constant(1e-3))
        want, _, wl = TS.make_gnn_train_step("sage", cfg, opt)(params, opt.init(params), g, y)
        part = gnn_dist.partition_edges(g.edge_src, g.edge_dst, g.edge_valid, g.n_nodes, 4)
        mesh = make_mesh((2, 2), ("group", "member"), device=cuda, virtual=True)
        for hier in (True, False):
            step = gnn_dist.make_sage_dist_step(cfg, opt, mesh, g.n_nodes, hierarchical=hier)
            new, _, loss = step(params, opt.init(params), g.node_feat, *part, y)
            assert abs(float(loss) - float(wl)) < 1e-4
            for k in want:
                assert float((new[k] - want[k]).abs().max()) < 1e-5, k
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
