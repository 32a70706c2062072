"""Graph construction in the port against the JAX package, bit for bit.

The same JAX ``EdgeList`` (as numpy) goes through both packages: the CSR,
the degree sort, the relabeled edges, the heavy core, the edge view and
the chunked edge view must be identical.  Also the bitmap helpers, the
``convert`` round trip, and the range/shape/dtype of the port's own
generator (torch cannot replay ``jax.random``'s stream).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import bfs_steps as jsteps
from repro.core import graph_build as jgb
from repro.core import heavy as jheavy
from repro.core import reorder as jreorder
from repro.core.hybrid_bfs import _pack_delta_words
from repro.core.kronecker import generate_edges as jax_generate_edges
from repro_torch import convert
from repro_torch.core import bfs_steps, graph_build, heavy, kronecker, pipeline, reorder
from repro_torch.data import graphs
from repro_torch.core.heavy import testbit as bit_at  # alias: pytest must not collect

torch.set_num_threads(2)


def np_(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def words(t):
    return np_(t).view(np.uint32)


def same(a, b):
    np.testing.assert_array_equal(np_(a), np.asarray(b))


@pytest.mark.parametrize("scale", [8, 9, 10, 11, 12])
def test_graph_construction_bitwise(scale):
    je = jax_generate_edges(scale, scale)
    te = convert.edge_list_from_numpy(np.asarray(je.src), np.asarray(je.dst),
                                      je.num_vertices, device="cpu")
    # CSR of the raw edge list
    jg0, tg0 = jgb.build_csr(je), graph_build.build_csr(te)
    for f in ("row_offsets", "col_indices", "edge_valid", "degree", "nnz"):
        same(getattr(tg0, f), getattr(jg0, f))
    same(tg0.edge_sources(), jg0.edge_sources())
    # degree sort + relabel + rebuild
    jr, tr = jreorder.degree_reorder(jg0.degree), reorder.degree_reorder(tg0.degree)
    for f in jr._fields:
        same(getattr(tr, f), getattr(jr, f))
    je1, te1 = jreorder.relabel_edges(je, jr), reorder.relabel_edges(te, tr)
    same(te1.src, je1.src)
    same(te1.dst, je1.dst)
    jg, tg = jgb.build_csr(je1), graph_build.build_csr(te1)
    for f in ("row_offsets", "col_indices", "edge_valid", "degree", "nnz"):
        same(getattr(tg, f), getattr(jg, f))
    # heavy core (a_core as uint32 words)
    jc, tc = jheavy.build_heavy_core(jg), heavy.build_heavy_core(tg)
    assert tc.k == jc.k and tc.threshold == jc.threshold
    np.testing.assert_array_equal(words(tc.a_core), np.asarray(jc.a_core))
    for f in ("k_heavy", "halo_src", "halo_dst", "halo_valid", "core_nnz"):
        same(getattr(tc, f), getattr(jc, f))
    assert int(tc.core_nnz) > 0
    # edge view + chunked edge view
    jev, tev = jsteps.edge_view(jg), bfs_steps.edge_view(tg)
    for f in ("src", "dst", "valid"):
        same(getattr(tev, f), getattr(jev, f))
    jch, tch = jsteps.chunk_edge_view(jev), bfs_steps.chunk_edge_view(tev)
    assert (tch.n_chunks, tch.chunk_size) == (jch.n_chunks, jch.chunk_size)
    for f in ("src", "dst", "valid", "src_lo", "src_hi"):
        same(getattr(tch, f), getattr(jch, f))
    # chunk liveness on a random frontier
    w = heavy.padded_bitmap_words(tg.num_vertices)
    rng = np.random.default_rng(scale)
    bm = np.where(rng.random(w) < 0.05,
                  rng.integers(0, 2**32, w, dtype=np.uint32), 0).astype(np.uint32)
    same(bfs_steps.chunk_frontier_mask(tch, convert.words_to_torch(bm, "cpu")),
         jsteps.chunk_frontier_mask(jch, jnp.asarray(bm)))


_ROW_GRAPHS: dict = {}


def row_graph(case):
    """(EdgeView, degree, HeavyCore or None) of the port on the CPU, cached."""
    if case not in _ROW_GRAPHS:
        if case.startswith("kron"):
            scale, core = int(case[4:6]), case.endswith("core")
            b = pipeline.build(pipeline.Graph500Config(
                scale=scale, seed=5, device="cpu", heavy_threshold=16 if core else None))
            assert (b.core is not None) == core
            _ROW_GRAPHS[case] = (b.ev, b.degree, b.core)
        else:
            el = (graphs.grid_graph(20, seed=5, device="cpu") if case == "grid"
                  else graphs.erdos_renyi_graph(400, avg_degree=6, seed=7, device="cpu"))
            if case == "isolated_tail":    # 57 vertices past the last with an edge
                el = kronecker.EdgeList(el.src, el.dst, el.num_vertices + 57)
            g = graph_build.build_csr(el)
            _ROW_GRAPHS[case] = (bfs_steps.edge_view(g), g.degree, None)
    return _ROW_GRAPHS[case]


@pytest.mark.parametrize("case", ["kron09", "kron09core", "kron11", "kron11core", "grid",
                                  "erdos_renyi", "isolated_tail"])
@pytest.mark.parametrize("n_chunks", [1, 7, 64, "past_the_entries"])
def test_edge_rows_chunk_bounds_match_the_chunked_view(case, n_chunks):
    # the rows keep of the chunks only their source ranges, computed from
    # the rows without building a chunk: the chunked view's, bit for bit
    ev, degree, core = row_graph(case)
    if case == "isolated_tail":
        assert bool((degree[-57:] == 0).all())
    e_pad = ev.src.shape[0]
    n = e_pad + 3 if n_chunks == "past_the_entries" else n_chunks
    rows = bfs_steps.edge_rows(ev, degree, core, n)
    want = bfs_steps.chunk_edge_view(ev, n)
    assert rows.n_chunks == want.n_chunks == n
    assert rows.src_lo.dtype == rows.src_hi.dtype == torch.int32
    same(rows.src_lo, np_(want.src_lo))
    same(rows.src_hi, np_(want.src_hi))
    if n_chunks == "past_the_entries":
        assert int((rows.src_hi < 0).sum()) >= 3      # empty chunks: (V, -1)
    assert rows.dst.data_ptr() == ev.dst.data_ptr()   # the view's own, not a copy


@pytest.mark.parametrize("n_bits", [1, 31, 32, 33, 1000, 32768 - 5])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_pack_unpack_testbit_match_jax(n_bits, density):
    rng = np.random.default_rng(n_bits)
    mask = rng.random(n_bits) < density
    tbm = heavy.pack_bitmap(torch.from_numpy(mask))
    jbm = jheavy.pack_bitmap(jnp.asarray(mask))
    np.testing.assert_array_equal(words(tbm), np.asarray(jbm))
    np.testing.assert_array_equal(np_(heavy.unpack_bitmap(tbm, n_bits)), mask)
    idx = rng.integers(0, n_bits, size=min(64, n_bits))
    np.testing.assert_array_equal(
        np_(bit_at(tbm, torch.from_numpy(idx))), mask[idx])
    # padded to the frontier_update tile, as the engine packs its delta
    w = heavy.padded_bitmap_words(n_bits)
    assert w == jheavy.padded_bitmap_words(n_bits)
    np.testing.assert_array_equal(words(heavy.pack_bitmap(torch.from_numpy(mask), w)),
                                  np.asarray(_pack_delta_words(jnp.asarray(mask), w)))


def test_pack_bitmap_bit31_wraps_to_same_bits():
    mask = np.zeros(64, bool)
    mask[31] = mask[63] = mask[32] = True
    t = heavy.pack_bitmap(torch.from_numpy(mask), 2)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(words(t), [0x80000000, 0x80000001])
    np.testing.assert_array_equal(words(t),
                                  np.asarray(_pack_delta_words(jnp.asarray(mask), 2)))


def test_testbit_sentinel_word_is_clamped_like_jax():
    # V a multiple of 32768: the sentinel id V reads word V // 32 == W,
    # one past the end; JAX clamps the gather, the port clamps the index.
    v = 32768
    w = heavy.padded_bitmap_words(v)
    assert v // 32 == w
    bm = np.zeros(w, np.uint32)
    bm[-1] = 0xFFFFFFFF
    idx = np.array([v, v - 1, 0], np.int32)
    got = np_(bit_at(convert.words_to_torch(bm, "cpu"), torch.from_numpy(idx)))
    want = np.asarray(jheavy.testbit(jnp.asarray(bm), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)


def test_convert_round_trip_and_built_graph():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 2**32, (64, 4), dtype=np.uint32)
    t = convert.words_to_torch(w, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(convert.words_to_numpy(t), w)
    # a JAX-built graph carried across equals the port's own build of it
    je = jax_generate_edges(5, 10)
    te = convert.edge_list_from_numpy(np.asarray(je.src), np.asarray(je.dst),
                                      je.num_vertices, device="cpu")
    g = graph_build.build_csr(reorder.relabel_edges(
        te, reorder.degree_reorder(graph_build.build_csr(te).degree)))
    core = heavy.build_heavy_core(g)
    ev = bfs_steps.edge_view(g)
    built = convert.built_from_numpy(
        np_(ev.src), np_(ev.dst), np_(ev.valid), np_(g.degree),
        num_vertices=g.num_vertices, a_core=words(core.a_core),
        k_heavy=int(core.k_heavy), device="cpu")
    assert built.nnz == int(g.nnz)
    for f in ("a_core", "k_heavy", "halo_src", "halo_dst", "halo_valid", "core_nnz"):
        assert torch.equal(getattr(built.core, f), getattr(core, f)), f
    assert built.core.k == core.k


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("permute", [False, True])
def test_generator_range_shape_dtype(seed, permute):
    e = kronecker.generate_edges(seed, 6, 4, permute=permute, device="cpu")
    assert e.num_vertices == 64 and e.num_edges == 4 * 64
    for t in (e.src, e.dst):
        assert t.dtype == torch.int32 and t.shape == (256,)
        assert int(t.min()) >= 0 and int(t.max()) < 64
    again = kronecker.generate_edges(seed, 6, 4, permute=permute, device="cpu")
    assert torch.equal(e.src, again.src) and torch.equal(e.dst, again.dst)
    roots = kronecker.sample_roots(seed, e, 8)
    assert roots.shape == (8,) and roots.dtype == torch.int32
    deg = graph_build.build_csr(e).degree
    endpoints = set(e.src.tolist()) | set(e.dst.tolist())
    assert set(roots.tolist()) <= endpoints
    # a root may only be isolated after self-loop removal
    loops = set(e.src[e.src == e.dst].tolist())
    assert all(int(deg[r]) > 0 or r in loops for r in roots.tolist())


def test_generator_skews_like_rmat():
    # R-MAT with A=0.57: vertex 0 is the heaviest by a wide margin.
    e = kronecker.generate_edges(3, 10, device="cpu")
    deg = graph_build.build_csr(e).degree
    assert int(deg.argmax()) == 0 and int(deg[0]) > 8 * float(deg.float().mean())
