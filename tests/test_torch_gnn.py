"""The GNN stack of the PyTorch port (``repro_torch.models.gnn``,
``data.sampler``, the GNN graphs of ``data.graphs``, ``configs.gnn_archs``,
the GNN train steps, the launcher's GNN branch, ``convert.gnn_*``) against
``repro`` on the same numpy inputs, on the CPU at the smoke configs.

``jax.random`` cannot be replayed in torch, so JAX's parameters and graphs
go through ``convert.gnn_params_from_numpy`` / ``graph_from_numpy``.  The
numpy parts (the sampler, ``static_block_specs``, ``make_molecule_batch``,
``build_triplets``, the feature graph's structure from one edge list) are
held bit for bit.  Floats: forwards within 1e-5 x max |out|; one train
step's loss within 1e-4 and every parameter within 1e-5 after AdamW (JAX's
own bound, ``tests/test_distributed.py``), and the gradients, which one
AdamW step hides (its update is about lr x sign(g)), within 1e-5 x each
leaf's largest |gradient| (float32 sums in another order; XLA's and torch's
float32 ``exp``/``sin``/``cos`` differ by an ulp).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import all_arch_ids as jall_arch_ids, all_cells as jall_cells
from repro.configs import get as jget
from repro.configs.gnn_archs import arch_with_dims as jarch_with_dims
from repro.core import build_csr as jbuild_csr, generate_edges as jgenerate_edges
from repro.data import graphs as JG
from repro.data.sampler import NeighborSampler as JSampler
from repro.data.sampler import static_block_specs as jstatic_block_specs
from repro.models import gnn as jgnn
from repro.optim import AdamW as JAdamW, constant as jconstant
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.configs import all_arch_ids, all_cells, get
from repro_torch.configs.gnn_archs import arch_with_dims
from repro_torch.data import graphs as G
from repro_torch.data.sampler import NeighborSampler, static_block_specs
from repro_torch.launch import train as launch_train
from repro_torch.models import gnn
from repro_torch.optim import AdamW, constant
from repro_torch.train import checkpoint
from repro_torch.train import train_step as TS

torch.set_num_threads(2)

GNN_ARCHS = ["dimenet", "equiformer-v2", "gat-cora", "graphsage-reddit"]
JINITS = {"gat-cora": jgnn.gat_init, "graphsage-reddit": jgnn.sage_init,
          "dimenet": jgnn.dimenet_init, "equiformer-v2": jgnn.equiformer_init}
N_MOLS = 4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_graph(jg) -> gnn.Graph:
    return convert.graph_from_numpy(
        np.asarray(jg.node_feat), np.asarray(jg.edge_src), np.asarray(jg.edge_dst),
        np.asarray(jg.edge_valid), jg.n_nodes,
        None if jg.edge_vec is None else np.asarray(jg.edge_vec),
        None if jg.graph_ids is None else np.asarray(jg.graph_ids), device="cpu")


def port_triplets(tri) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tri.items()}


_CASES: dict = {}


def case(arch: str):
    """JAX's smoke graph, inputs and parameters for ``arch``, and the
    port's copies (cached per arch)."""
    if arch not in _CASES:
        cfg, jcfg = get(arch).make_smoke_config(), jget(arch).make_smoke_config()
        jp = JINITS[arch](jax.random.PRNGKey(0), jcfg)
        if arch in ("gat-cora", "graphsage-reddit"):
            jg, labels = JG.make_feature_graph(0, 7, d_feat=jcfg.d_in,
                                               n_classes=jcfg.n_classes, edge_factor=4)
            jargs = (jg, labels)
            args = (port_graph(jg), torch.from_numpy(np.array(labels)))
        else:
            jg, species, tri = JG.make_molecule_batch(0, N_MOLS, 8, 16)
            targets = np.linspace(-1.0, 1.0, N_MOLS if arch == "dimenet" else jg.n_nodes,
                                  dtype=np.float32)
            g, sp = port_graph(jg), torch.from_numpy(np.array(species))
            if arch == "dimenet":
                jargs = (jg, species, tri, jnp.asarray(targets))
                args = (g, sp, port_triplets(tri), torch.from_numpy(targets))
            else:
                jargs = (jg, species, jnp.asarray(targets))
                args = (g, sp, torch.from_numpy(targets))
        params = convert.gnn_params_from_numpy(np_tree(jp), arch, cfg, device="cpu")
        _CASES[arch] = (cfg, jcfg, jp, params, jargs, args)
    return _CASES[arch]


def forward_pair(arch):
    """JAX's forward (jitted) and the port's on the same inputs; DimeNet's
    per-graph energies."""
    cfg, jcfg, jp, params, jargs, args = case(arch)
    fwd, jfwd = {
        "gat-cora": (lambda p, a: gnn.gat_forward(p, a[0], cfg),
                     lambda p, a: jgnn.gat_forward(p, a[0], jcfg)),
        "graphsage-reddit": (lambda p, a: gnn.sage_forward(p, a[0], cfg),
                             lambda p, a: jgnn.sage_forward(p, a[0], jcfg)),
        "dimenet": (lambda p, a: gnn.dimenet_energy(p, *a[:3], cfg, n_graphs=N_MOLS),
                    lambda p, a: jgnn.dimenet_energy(p, *a[:3], jcfg, n_graphs=N_MOLS)),
        "equiformer-v2": (lambda p, a: gnn.equiformer_forward(p, *a[:2], cfg),
                          lambda p, a: jgnn.equiformer_forward(p, *a[:2], jcfg)),
    }[arch]
    return jax.jit(jfwd)(jp, jargs), fwd(params, args)


def assert_scaled(got: torch.Tensor, want, tol: float, what: str):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


# ---------------------------------------------------------------------------
# Forwards, segment softmax, sampled blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_matches_jax(arch):
    want, got = forward_pair(arch)
    with torch.no_grad():
        assert_scaled(got, want, 1e-5, arch)
    if arch == "dimenet":    # per node, before the per-graph sum
        cfg, jcfg, jp, params, jargs, args = case(arch)
        want = jax.jit(lambda p, a: jgnn.dimenet_forward(p, *a[:3], jcfg))(jp, jargs)
        with torch.no_grad():
            assert_scaled(gnn.dimenet_forward(params, *args[:3], cfg), want, 1e-5,
                          "dimenet per node")


def test_segment_softmax_matches_jax():
    jg, _ = JG.make_feature_graph(1, 6, d_feat=4, edge_factor=4)
    n = jg.n_nodes
    valid = np.asarray(jg.edge_valid).copy()
    dst = np.asarray(jg.edge_dst)
    # every edge into nodes 0..3 invalid (all-invalid rows), nodes >= n-8
    # receive none (empty segments), and some scores are +-inf
    valid &= dst >= 4
    dst = np.where(dst >= n - 8, 0, dst)
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(len(dst), 3)).astype(np.float32) * 4
    scores[::97, 1] = np.inf
    scores[5::89, 2] = -np.inf
    scores = np.where(valid[:, None], scores, -np.inf).astype(np.float32)
    seg = np.where(valid, dst, n).astype(np.int32)
    want = np.asarray(jgnn.segment_softmax(jnp.asarray(scores), jnp.asarray(seg), n))
    got = gnn.segment_softmax(torch.from_numpy(scores), torch.from_numpy(seg), n).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-6)
    assert (got[~valid] == 0).all() and np.isnan(want).any()
    # the weights of a segment sum to 1 where it has a finite score and no
    # +inf (a +inf score gives NaN weights, in both packages)
    sums = np.zeros((n + 1, 3), np.float64)
    np.add.at(sums, seg, np.nan_to_num(got))
    fin, nan = np.zeros((n + 1, 3), bool), np.zeros((n + 1, 3), bool)
    np.logical_or.at(fin, seg, np.isfinite(scores))
    np.logical_or.at(nan, seg, np.isnan(want))
    np.testing.assert_allclose(sums[:n][fin[:n] & ~nan[:n]], 1.0, rtol=1e-5)


def test_segment_max_leaves_empty_segments_at_neg_inf():
    x = torch.tensor([[1.0], [-2.0], [3.0]])
    got = gnn.segment_max(x, torch.tensor([0, 0, 2]), 4)
    want = jax.ops.segment_max(jnp.asarray(x.numpy()), jnp.asarray([0, 0, 2]),
                               num_segments=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1, 0] == -np.inf and got[3, 0] == -np.inf


def sampled(seed=0, fanouts=(3, 2)):
    edges = jgenerate_edges(2, 9)
    jcsr = jbuild_csr(edges)
    ro, ci = np.asarray(jcsr.row_offsets), np.asarray(jcsr.col_indices)
    seeds = np.array([1, 2, 3, 4, 5, 6, 7, 8, 200, 511])
    jb = JSampler(ro, ci, fanouts, seed=seed).sample(seeds)
    tb = NeighborSampler(torch.from_numpy(ro.copy()), ci, fanouts, seed=seed,
                         device="cpu").sample(seeds)
    return jb, tb


def test_sampler_matches_jax_bit_for_bit():
    for seed, fanouts in ((0, (3, 2)), (1, (4, 3)), (5, (15, 10))):
        jb, tb = sampled(seed, fanouts)
        np.testing.assert_array_equal(tb.node_ids, jb.node_ids)
        np.testing.assert_array_equal(tb.seeds, jb.seeds)
        assert len(tb.blocks) == len(jb.blocks) == len(fanouts)
        for got, want in zip(tb.blocks, jb.blocks):
            assert got["n_dst"] == want["n_dst"]
            for k in ("src", "dst", "valid"):
                assert got[k].dtype == {"src": torch.int32, "dst": torch.int32,
                                        "valid": torch.bool}[k]
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_static_block_specs_match_jax():
    for b, f in ((4, (3, 2)), (1024, (15, 10)), (7, (25, 10, 5)), (3, ())):
        assert static_block_specs(b, f) == jstatic_block_specs(b, f)


def test_sage_forward_blocks_matches_jax():
    cfg, jcfg, jp, params, jargs, _ = case("graphsage-reddit")
    jb, _ = sampled()
    feats = np.random.default_rng(3).normal(size=(len(jb.node_ids), cfg.d_in)) \
        .astype(np.float32)
    want = jgnn.sage_forward_blocks(jp, jnp.asarray(feats), jb.blocks, jcfg)
    blocks = convert.blocks_from_numpy(jax.tree.map(np.asarray, jb.blocks), device="cpu")
    got = gnn.sage_forward_blocks(params, torch.from_numpy(feats), blocks, cfg)
    assert got.shape == (len(jb.seeds), cfg.n_classes)
    assert_scaled(got, want, 1e-5, "sage blocks")


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

class Capture:
    """An optimizer whose update hands back the gradients as the state."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        return params, grads


def make_steps(arch, opt, jopt):
    cfg, jcfg = case(arch)[:2]
    if arch in ("gat-cora", "graphsage-reddit"):
        kind = "gat" if arch == "gat-cora" else "sage"
        return TS.make_gnn_train_step(kind, cfg, opt), JTS.make_gnn_train_step(kind, jcfg, jopt)
    if arch == "dimenet":
        return (TS.make_dimenet_train_step(cfg, opt, N_MOLS),
                JTS.make_dimenet_train_step(jcfg, jopt, N_MOLS))
    return TS.make_equiformer_train_step(cfg, opt), JTS.make_equiformer_train_step(jcfg, jopt)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_train_step_matches_jax(arch):
    cfg, jcfg, jp, params, jargs, args = case(arch)
    # the gradients
    step, jstep = make_steps(arch, Capture(), Capture())
    _, grads, loss = step(params, None, *args)
    _, jgrads, jloss = jax.jit(jstep)(jp, None, *jargs)
    assert abs(float(loss) - float(jloss)) < 1e-4
    jflat = convert.paths_from_tree(np_tree(jgrads))
    assert set(jflat) == set(grads)
    for k, g in grads.items():
        assert g.shape == jflat[k].shape and g.dtype == torch.float32, k
        scale = max(np.abs(jflat[k]).max(), 1e-30)
        assert np.abs(g.numpy() - jflat[k]).max() <= 1e-5 * scale, k
    # one AdamW step
    opt, jopt = AdamW(constant(1e-3)), JAdamW(jconstant(1e-3))
    step, jstep = make_steps(arch, opt, jopt)
    new, _, loss = step(params, opt.init(params), *args)
    jnew, _, jloss = jax.jit(jstep)(jp, jopt.init(jp), *jargs)
    assert abs(float(loss) - float(jloss)) < 1e-4
    jflat = convert.paths_from_tree(np_tree(jnew))
    for k, p in new.items():
        np.testing.assert_allclose(p.numpy(), jflat[k], rtol=0, atol=1e-5, err_msg=k)
    assert gnn.param_template(arch, cfg).keys() == new.keys()


def test_equiformer_unused_weight_gets_zero_gradient():
    cfg, _, _, params, _, args = case("equiformer-v2")
    step, _ = make_steps("equiformer-v2", Capture(), Capture())
    _, grads, _ = step(params, None, *args)
    assert all(not grads[f"layers/{i}/w_val"].any() for i in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# Graphs, molecules, triplets
# ---------------------------------------------------------------------------

def test_feature_graph_structure_matches_jax_bit_for_bit():
    for seed, scale, ef in ((0, 7, 4), (3, 8, 8)):
        jg, jlabels = JG.make_feature_graph(seed, scale, d_feat=6, n_classes=5,
                                            edge_factor=ef)
        edges = jgenerate_edges(seed, scale, ef)
        el = convert.edge_list_from_numpy(np.asarray(edges.src), np.asarray(edges.dst),
                                          edges.num_vertices, device="cpu")
        _, src, dst, valid = G.feature_graph_structure(el)
        np.testing.assert_array_equal(src.numpy(), np.asarray(jg.edge_src))
        np.testing.assert_array_equal(dst.numpy(), np.asarray(jg.edge_dst))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jg.edge_valid))
        ro, ci = G.csr_of(port_graph(jg))
        jcsr = jbuild_csr(edges)
        assert ro.shape[0] == jg.n_nodes + 1 and int(ro[-1]) == int(np.asarray(jg.edge_valid).sum())
        assert int(ro[-1]) == int(jcsr.nnz)
        np.testing.assert_array_equal(ci.numpy(), np.asarray(jg.edge_dst))


def test_port_feature_graph_shapes_and_labels():
    g, labels = G.make_feature_graph(0, 7, d_feat=8, n_classes=3, edge_factor=4,
                                     with_edge_vec=True, device="cpu")
    jg, _ = JG.make_feature_graph(0, 7, d_feat=8, n_classes=3, edge_factor=4,
                                  with_edge_vec=True)
    assert g.node_feat.shape == (g.n_nodes, 8) and g.node_feat.dtype == torch.float32
    assert labels.dtype == torch.int32 and int(labels.max()) < 3 and int(labels.min()) >= 0
    assert g.edge_vec.shape == tuple(jg.edge_vec.shape)
    # the structure is the port's generator's; the graph's shape is JAX's
    assert g.edge_src.shape == jg.edge_src.shape and g.n_nodes == jg.n_nodes
    again, _ = G.make_feature_graph(0, 7, d_feat=8, n_classes=3, edge_factor=4,
                                    with_edge_vec=True, device="cpu")
    assert torch.equal(again.node_feat, g.node_feat)


@pytest.mark.parametrize("shape", [(0, 4, 8, 16), (3, 3, 6, 10), (1, 2, 30, 64)])
def test_molecule_batch_and_triplets_match_jax_bit_for_bit(shape):
    jg, jspecies, jtri = JG.make_molecule_batch(*shape)
    g, species, tri = G.make_molecule_batch(*shape, device="cpu")
    assert g.n_nodes == jg.n_nodes
    for f in ("node_feat", "edge_src", "edge_dst", "edge_valid", "edge_vec", "graph_ids"):
        want = np.asarray(getattr(jg, f))
        got = getattr(g, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(species.numpy(), np.asarray(jspecies))
    for k in ("t_in", "t_out", "angle", "valid"):
        assert tri[k].numpy().dtype == np.asarray(jtri[k]).dtype, k
        np.testing.assert_array_equal(tri[k].numpy(), np.asarray(jtri[k]), err_msg=k)
    src, dst, vec = (np.asarray(jg.edge_src), np.asarray(jg.edge_dst),
                     np.asarray(jg.edge_vec))
    small = G.build_triplets(src, dst, vec, max_triplets=7, device="cpu")
    jsmall = JG.build_triplets(src, dst, vec, max_triplets=7)
    for k in small:
        np.testing.assert_array_equal(small[k].numpy(), np.asarray(jsmall[k]))


# ---------------------------------------------------------------------------
# Configs, parameters, the launcher
# ---------------------------------------------------------------------------

def test_channel_layout_and_m_groups_match_jax():
    for lm in ((6, 2), (2, 1), (3, 3), (0, 0)):
        cfg = gnn.EquiformerConfig(l_max=lm[0], m_max=lm[1])
        jcfg = jgnn.EquiformerConfig(l_max=lm[0], m_max=lm[1])
        assert cfg.channel_layout == jcfg.channel_layout
        assert gnn._m_groups(cfg) == jgnn._m_groups(jcfg)
    assert gnn.EquiformerConfig(l_max=6, m_max=2).n_sph == 29   # 1+3+5+5+5+5+5
    assert gnn.EquiformerConfig(l_max=2, m_max=1).n_sph == 1 + 3 + 3


def test_registry_equals_jax():
    assert all_arch_ids() == jall_arch_ids() and len(all_arch_ids()) == 11
    assert all_cells() == jall_cells()
    assert len([c for c in all_cells() if c[0] != "graph500"]) == 40
    for arch in GNN_ARCHS:
        spec, jspec = get(arch), jget(arch)
        assert spec.family == jspec.family == "gnn"
        assert [dataclasses.asdict(s) for s in spec.shapes] == \
            [dataclasses.asdict(s) for s in jspec.shapes]
        assert (spec.source, spec.notes) == (jspec.source, jspec.notes)
        for make in ("make_config", "make_smoke_config"):
            cfg, jcfg = getattr(spec, make)(), getattr(jspec, make)()
            assert type(cfg).__name__ == type(jcfg).__name__
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            for cell in spec.shapes:
                d_feat = cell.dims.get("d_feat", 1)
                assert dataclasses.asdict(arch_with_dims(cfg, d_feat, 7)) == \
                    dataclasses.asdict(jarch_with_dims(jcfg, d_feat, 7))


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_init_shapes_keys_and_scale_match_jax(arch):
    spec, jspec = get(arch), jget(arch)
    cfg, jcfg = spec.make_config(), jspec.make_config()
    jshapes = jax.eval_shape(lambda k: JINITS[arch](k, jcfg), jax.random.PRNGKey(0))
    jflat = convert.paths_from_tree(jshapes)
    template = gnn.param_template(arch, cfg)
    assert set(template) == set(jflat)
    for k, t in template.items():
        assert tuple(t.shape) == tuple(jflat[k].shape) and t.dtype == torch.float32, k
    smoke = gnn.INITS[arch](spec.make_smoke_config(), seed=0, device="cpu")
    assert torch.equal(smoke[next(iter(smoke))],
                       gnn.INITS[arch](spec.make_smoke_config(), seed=0, device="cpu")
                       [next(iter(smoke))])
    # Glorot: std sqrt(2 / (fan_in + fan_out)) on the largest smoke leaf
    k, w = max(smoke.items(), key=lambda kv: kv[1].numel())
    fan = sum(w.shape[-2:])
    assert abs(float(w.std()) / (2.0 / fan) ** 0.5 - 1) < 0.1, k
    with pytest.raises(ValueError, match="shapes"):
        convert.gnn_params_from_numpy({k: np.zeros((1,), np.float32)}, arch,
                                      spec.make_smoke_config(), device="cpu")


def test_params_round_trip_through_numpy():
    cfg, _, jp, params, _, _ = case("dimenet")
    back = convert.gnn_params_to_numpy(params)
    jflat, bflat = convert.paths_from_tree(np_tree(jp)), convert.paths_from_tree(back)
    assert set(jflat) == set(bflat)
    for k in jflat:
        np.testing.assert_array_equal(bflat[k], jflat[k])


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_launcher_gnn_branch_trains_and_resumes_bit_for_bit(arch, tmp_path):
    logs = []
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    out = launch_train.main(["--arch", arch, "--steps", "4", "--scale", "7",
                             "--device", "cpu", "--ckpt-dir", full], log=logs.append)
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert "family=gnn" in logs[0] and logs[-1].startswith("[train] done")
    # resume from the step-2 checkpoint: the same losses and parameters
    os.makedirs(part)
    os.rename(os.path.join(full, "step_0000000002"), os.path.join(part, "step_0000000002"))
    again = launch_train.main(["--arch", arch, "--steps", "4", "--scale", "7",
                               "--device", "cpu", "--ckpt-dir", part], log=logs.append)
    assert again["losses"] == out["losses"][2:]
    a = np.load(os.path.join(full, "step_0000000004", "arrays.npz"))
    b = np.load(os.path.join(part, "step_0000000004", "arrays.npz"))
    assert sorted(a.files) == sorted(b.files)
    assert any(f.startswith("params|layers|") or f.startswith("params|blocks|")
               for f in a.files)
    for f in a.files:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert checkpoint.latest_step(part) == 4


def test_launcher_rejects_unknown_family(monkeypatch):
    from repro_torch.configs import base
    spec = dataclasses.replace(base.REGISTRY["gat-cora"], family="vision")
    monkeypatch.setitem(base.REGISTRY, "gat-cora", spec)
    with pytest.raises(ValueError, match="family 'vision'"):
        launch_train.main(["--arch", "gat-cora", "--steps", "1", "--device", "cpu"],
                          log=lambda m: None)
