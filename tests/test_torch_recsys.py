"""The port's xDeepFM serving path against the JAX package's on the same
numpy parameters and ids: embedding bags, the serve step (both CIN paths)
and retrieval scoring, plus the port's own configs, init and data stream.

Tolerance: the two packages sum fp32 in different orders (XLA's dots vs
PyTorch's), so outputs agree to rtol = atol = 1e-5 on probabilities and
embeddings, and rtol = atol = 1e-4 on retrieval scores (a 1,000-term
matvec over values of order 10).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import recsys as jrecsys
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.configs import get
from repro_torch.configs.base import RECSYS_SHAPES
from repro_torch.data.synthetic import recsys_batch
from repro_torch.models import recsys
from repro_torch.train import train_step as ts

torch.set_num_threads(2)

NARROW = recsys.XDeepFMConfig(n_sparse=39, embed_dim=10, cin_layers=(16, 16),
                              mlp_layers=(32,), rows_per_field=256)


def numpy_params(cfg, seed):
    """A parameter pytree in the JAX layouts, drawn with numpy at the JAX
    package's init scales (biases non-zero so that they are exercised)."""
    rng = np.random.default_rng(seed)
    f, d = cfg.n_sparse, cfg.embed_dim
    rows = cfg.rows_per_field * f

    def normal(shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    p = {"table": normal((rows, d), 0.3), "linear": normal((rows,), 0.01),
         "bias": np.float32(0.05)}
    cin, prev = [], f
    for h in cfg.cin_layers:
        cin.append({"w": normal((h, f, prev), np.sqrt(1.0 / (f * prev)))})
        prev = h
    p["cin"] = cin
    p["cin_out"] = normal((sum(cfg.cin_layers), 1), 0.1)
    mlp, prev = [], f * d
    for h in cfg.mlp_layers:
        mlp.append({"w": normal((prev, h), np.sqrt(2.0 / prev)),
                    "b": normal((h,), 0.01)})
        prev = h
    p["mlp"] = mlp
    p["mlp_out"] = normal((prev, 1), 0.1)
    return p


def jax_tree(p):
    return {k: ([{kk: jnp.asarray(vv) for kk, vv in layer.items()} for layer in v]
                if isinstance(v, list) else jnp.asarray(v)) for k, v in p.items()}


def jax_config(cfg, use_cin_kernel):
    return jrecsys.XDeepFMConfig(**{**dataclasses.asdict(cfg),
                                    "use_cin_kernel": use_cin_kernel})


def numpy_ids(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.rows_per_field, (batch, cfg.n_sparse), dtype=np.int32)


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_jax(mode, weighted):
    rng = np.random.default_rng(3)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, 40).astype(np.int32)
    bags = rng.integers(0, 8, 40).astype(np.int32)  # bag 7 == n_bags drops
    weights = rng.random(40).astype(np.float32) if weighted else None
    want = jrecsys.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bags),
                                 7, None if weights is None else jnp.asarray(weights),
                                 mode=mode)
    got = recsys.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                               torch.from_numpy(bags), 7,
                               None if weights is None else torch.from_numpy(weights),
                               mode=mode)
    assert got.shape == (7, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_embedding_bag_empty_bag_and_drop():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([1, 2, 3])
    bags = torch.tensor([0, 0, 2])  # bag 1 empty; id 3 in bag 2 == n_bags drops
    out = recsys.embedding_bag(table, ids, bags, 2, mode="mean")
    np.testing.assert_array_equal(out.numpy(), [[4.5, 5.5, 6.5], [0, 0, 0]])


@pytest.mark.parametrize("use_cin_kernel", [False, True])
@pytest.mark.parametrize("which", ["smoke", "narrow"])
def test_serve_step_matches_jax(which, use_cin_kernel):
    cfg = get("xdeepfm").make_smoke_config() if which == "smoke" else NARROW
    cfg = dataclasses.replace(cfg, use_cin_kernel=use_cin_kernel)
    p = numpy_params(cfg, seed=11)
    ids = numpy_ids(cfg, 64, seed=12)
    want = jts.make_xdeepfm_serve_step(jax_config(cfg, use_cin_kernel))(
        jax_tree(p), jnp.asarray(ids))
    params = convert.xdeepfm_params_from_numpy(p, cfg, device="cpu")
    got = ts.make_xdeepfm_serve_step(cfg)(params, torch.from_numpy(ids))
    assert got.shape == (64,) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the probabilities are spread out, so the comparison has teeth
    assert float(got.std()) > 0.01


@pytest.mark.parametrize("which", ["smoke", "narrow"])
def test_retrieval_step_matches_jax(which):
    cfg = get("xdeepfm").make_smoke_config() if which == "smoke" else NARROW
    p = numpy_params(cfg, seed=21)
    q = numpy_ids(cfg, 1, seed=22)
    cand = np.random.default_rng(23).normal(size=(1000, cfg.mlp_layers[-1])) \
        .astype(np.float32)
    want = jts.make_retrieval_step(jax_config(cfg, False))(
        jax_tree(p), jnp.asarray(q), jnp.asarray(cand))
    params = convert.xdeepfm_params_from_numpy(p, cfg, device="cpu")
    got = ts.make_retrieval_step(cfg)(params, torch.from_numpy(q), torch.from_numpy(cand))
    assert got.shape == (1000,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_cin_paths_agree_on_full_width_layer():
    # the kernel path (plain outer product on the CPU) and the einsum path
    # at the full-width layer shape F0 = 39, Fl = H = 200, D = 10
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.normal(size=(8, 39, 10)).astype(np.float32))
    xl = torch.from_numpy(rng.normal(size=(8, 200, 10)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(200, 39, 200)) / np.sqrt(39 * 200))
                         .astype(np.float32))
    from repro_torch.kernels import ops
    np.testing.assert_allclose(ops.cin_layer(x0, xl, w).numpy(),
                               recsys.cin_layer_einsum(x0, xl, w).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_configs_match_jax():
    spec, jspec = get("xdeepfm"), jax_get("xdeepfm")
    for make in ("make_config", "make_smoke_config"):
        assert dataclasses.asdict(getattr(spec, make)()) == \
            dataclasses.asdict(getattr(jspec, make)())
    assert [(s.name, s.kind, s.dims) for s in RECSYS_SHAPES] == \
        [(s.name, s.kind, s.dims) for s in jspec.shapes]
    assert spec.shape("serve_bulk").dims["batch"] == 262144
    assert dataclasses.asdict(recsys.XDeepFMConfig()) == \
        dataclasses.asdict(jrecsys.XDeepFMConfig())


def test_init_params_layouts_and_scales():
    cfg = dataclasses.replace(NARROW, rows_per_field=64)
    p = recsys.init_params(cfg, seed=0, device="cpu")
    assert p["table"].shape == (39 * 64, 10) and p["linear"].shape == (39 * 64,)
    assert [tuple(w.shape) for w in recsys.cin_weights(p)] == [(16, 39, 39), (16, 39, 16)]
    assert [(tuple(w.shape), tuple(b.shape)) for w, b in recsys.mlp_layers(p)] == \
        [((390, 32), (32,))]
    assert p["cin_out"].shape == (32, 1) and p["mlp_out"].shape == (32, 1)
    assert abs(float(p["table"].std()) - 0.01) < 0.001
    assert abs(float(p["cin/0/w"].std()) - np.sqrt(1 / (39 * 39))) < 0.003
    again = recsys.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(p["table"], again["table"]) and \
        torch.equal(p["cin/1/w"], again["cin/1/w"])


def test_recsys_batch_skew_and_determinism():
    b = recsys_batch(0, 0, 4096, 10, 10000, device="cpu")
    ids, labels = b["ids"], b["labels"]
    assert ids.shape == (4096, 10) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) <= 9999
    # power law: low ids are hot (the JAX stream's property, tests/test_data.py)
    assert float((ids < 10).float().mean()) > 0.5
    assert abs(float(labels.mean()) - 0.25) < 0.03
    assert torch.equal(ids, recsys_batch(0, 0, 4096, 10, 10000, device="cpu")["ids"])
    assert not torch.equal(ids, recsys_batch(0, 1, 4096, 10, 10000, device="cpu")["ids"])


def test_xdeepfm_entry_points_need_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = get("xdeepfm").make_smoke_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recsys.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recsys_batch(0, 0, 4, cfg.n_sparse, cfg.rows_per_field)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.xdeepfm_params_from_numpy(numpy_params(cfg, 0), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        recsys.init_params(cfg, device="cuda")
