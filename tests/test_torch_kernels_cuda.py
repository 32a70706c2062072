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
    assert bitmap_ops.scratch_for(dev, side.cuda_stream)[1] != \
        bitmap_ops.scratch_for(dev, torch.cuda.current_stream().cuda_stream)[1]


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
    a8 = torch.ones((128, 128), dtype=torch.int8, device=cuda)
    ops.multi_source_spmv(a8, a8)
    x = torch.ones((4, 3, 2), device=cuda)
    ops.cin_layer(x, x, torch.ones((5, 3, 3), device=cuda))
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "frontier_update": 1, "core_spmv": 1, "spmv_mxu": 1, "cin_layer": 1}


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
    # F0 split over 5 blocks with a ragged last slab; B = 7 splits the
    # filters too; D = 3 and 4 with H = 70
    (513, 39, 200, 200, 10), (7, 39, 39, 200, 10), (96, 12, 20, 70, 3),
    (100, 12, 20, 70, 4),
    # Fl > 312 and F0 > 64 per split: xl and x0 taken in chunks
    (256, 6, 400, 40, 10), (8192, 150, 20, 30, 4),
    # H = 300: 19 filter tiles in two blocks of up to 16
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
def test_cin_layer_split_path_is_deterministic(cuda):
    # B = 512 splits the F0 sum over blocks; the partials are summed in a
    # fixed order, so two calls give the same bits
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
