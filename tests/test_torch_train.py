"""The port's xDeepFM training stack against the JAX package's.

Schedules, optimizers, gradient compression, the loss and its gradients,
the train step, checkpoints (in both directions), the loop's resume, the
elastic helpers, the arch registry and the launcher, each on the same
numpy inputs through both packages.  Tolerances, and why:

  * schedules: bitwise in warmup and on the plateau; rtol 2e-7 where
    ``cos`` or ``pow`` is evaluated (XLA's and torch's float32
    transcendentals may differ by an ulp);
  * optimizer updates: rtol 1e-6 / atol 1e-7 (the global-norm clip sums in
    JAX's leaf order; only the order inside a leaf's sum differs);
  * ``fp8_e4m3_sim``: payload and scales bitwise;
  * the loss rtol 1e-6, its gradients rtol 1e-5 / atol 1e-9, three AdamW
    steps: losses rtol 1e-6, parameters atol 1e-6 (float32 reductions in
    another order);
  * checkpoints and the loop's resume: bit for bit.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.data import synthetic as JS
from repro.models import recsys as jrecsys
from repro.optim import compression as jcomp
from repro.optim import optimizer as jopt
from repro.train import checkpoint as jckpt
from repro.train import elastic as jelastic
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.comms.mesh import make_mesh
from repro_torch.configs import all_arch_ids, all_cells, get
from repro_torch.core import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import recsys
from repro_torch.optim import compression
from repro_torch.optim import optimizer as opt
from repro_torch.train import checkpoint, elastic
from repro_torch.train import train_step as TS
from repro_torch.train.loop import LoopConfig, run_loop

torch.set_num_threads(2)

NARROW = dict(n_sparse=39, embed_dim=10, cin_layers=(16, 16), mlp_layers=(32,),
              rows_per_field=256)
B = 64


def configs(which):
    """(JAX config, port config) of the smoke or the narrow 39-field config."""
    jcfg = jget("xdeepfm").make_smoke_config() if which == "smoke" else \
        jrecsys.XDeepFMConfig(**NARROW)
    return jcfg, recsys.XDeepFMConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _batch(jcfg, i):
    return {k: np.asarray(v) for k, v in JS.recsys_batch(
        0, i, B, jcfg.n_sparse, jcfg.rows_per_field).items()}


def batches(jcfg, n):
    """JAX's synthetic batches (power-law ids: rows repeat) as numpy, drawn
    once per config and step (the tests copy them, see :func:`tb`)."""
    return [_batch(jcfg, i) for i in range(n)]


def tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_params(jcfg):
    """JAX's initial parameters, drawn once per config under ``jax.jit``
    (its arrays are immutable; the port takes them through ``convert``)."""
    return jax.jit(jrecsys.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)


def port_params(jp, cfg):
    return convert.xdeepfm_params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")


def flat_np(tree) -> dict:
    return convert.paths_from_tree(jax.tree.map(np.asarray, tree))


def assert_tree_close(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k], err_msg=k, **tol)


def assert_tree_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------------------------
# Schedules, optimizers, compression
# ---------------------------------------------------------------------------

SCHEDULES = {
    # name: (schedule of a package, the steps computed without cos / pow)
    "cosine": (lambda m: m.cosine(1e-3, 5, 40), range(0, 5)),
    "cosine_short": (lambda m: m.cosine(3e-4, 5, 20), range(0, 5)),
    "wsd": (lambda m: m.wsd(3e-4, 5, 10, 10), range(0, 15)),
    "constant": (lambda m: m.constant(0.1), range(0, 41)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_equal_to_jax(name):
    make, exact = SCHEDULES[name]
    js, ts = make(jopt), make(opt)
    for step in range(41):
        want = np.asarray(js(jnp.int32(step)))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        if step in exact:
            assert got.numpy() == want, (step, got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, err_msg=str(step))


def seeded_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32),
            "layers": [{"k": rng.normal(size=(3, 3)).astype(np.float32)}
                       for _ in range(12)]}


@pytest.mark.parametrize("kind,clip", [("adamw", 1.0), ("adamw", None), ("adamw", 1e-3),
                                       ("sgd", None)])
def test_optimizer_updates_equal_to_jax(kind, clip):
    params = seeded_tree(0)
    if kind == "adamw":
        jo = jopt.AdamW(jopt.cosine(1e-2, 2, 10), grad_clip=clip)
        to = opt.AdamW(opt.cosine(1e-2, 2, 10), grad_clip=clip)
    else:
        jo, to = jopt.SGD(jopt.constant(0.1)), opt.SGD(opt.constant(0.1))
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in convert.paths_from_tree(params).items()}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(4):
        g = seeded_tree(10 + i)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update({k: torch.from_numpy(v.copy())
                            for k, v in convert.paths_from_tree(g).items()}, ts, tp)
    assert_tree_close(tp, flat_np(jp), rtol=1e-6, atol=1e-7)
    assert int(ts.step) == int(js.step) == 4
    mom = (ts.m, js.m) if kind == "adamw" else (ts.momentum, js.momentum)
    assert_tree_close(mom[0], flat_np(mom[1]), rtol=1e-6, atol=1e-7)


def test_leaf_order_is_jax_leaf_order():
    tree = seeded_tree(0)
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = opt.leaf_order(convert.paths_from_tree(tree))
    assert [k.replace("/", "") for k in got] == \
        [w.replace("[", "").replace("]", "").replace("'", "") for w in want]
    assert got.index("layers/2/k") < got.index("layers/10/k")


def test_adamw_converges_and_clip_bounds_update():
    o = opt.AdamW(opt.constant(0.1), weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = o.init(params)
    for _ in range(200):
        params, state = o.update({"w": 2 * params["w"]}, state, params)
    assert float((params["w"] ** 2).sum()) < 1e-2
    o = opt.AdamW(opt.constant(1.0), grad_clip=1e-3, weight_decay=0.0)
    p = {"w": torch.zeros(4)}
    p2, _ = o.update({"w": torch.full((4,), 1e6)}, o.init(p), p)
    assert torch.isfinite(p2["w"]).all() and torch.equal(p["w"], torch.zeros(4))
    sgd = opt.SGD(opt.constant(0.1), momentum=0.0)
    p = {"w": torch.tensor([1.0])}
    p3, _ = sgd.update({"w": torch.tensor([1.0])}, sgd.init(p), p)
    np.testing.assert_allclose(p3["w"].numpy(), [0.9], rtol=1e-6)


def test_fp8_and_bf16_compression_equal_to_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000,)).astype(np.float32) * 10
    x[:5] = [0.0, 448.0, -1e-20, 3e-39, 1e30]
    jp, js = jcomp.fp8_e4m3_sim(jnp.asarray(x))
    tp, ts = compression.fp8_e4m3_sim(torch.from_numpy(x))
    assert tp.dtype == torch.bfloat16 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.float().numpy(), np.asarray(jp, np.float32))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = compression.fp8_e4m3_restore(tp, ts, x.shape, x.size)
    jback = jcomp.fp8_e4m3_restore(jp, js, x.shape, x.size)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=1e-2)
    y = x[5:]
    rel = np.abs(back.numpy()[5:] - y) / (np.abs(y) + 1e-6)
    assert np.median(rel) < 0.07
    tree = {"a": torch.from_numpy(x), "b": torch.ones(3, dtype=torch.float64)}
    packed = compression.compress_tree_bf16(tree)
    assert all(v.dtype == torch.bfloat16 for v in packed.values())
    np.testing.assert_array_equal(
        packed["a"].float().numpy(),
        np.asarray(jcomp.to_bf16(jnp.asarray(x)), np.float32))
    out = compression.decompress_tree(packed, tree)
    assert out["b"].dtype == torch.float64 and out["a"].dtype == torch.float32


def test_softmax_xent_equal_to_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    want = np.asarray(JTS.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = TS.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# xDeepFM: loss, gradients, train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["smoke", "narrow"])
def test_loss_and_gradients_equal_to_jax(which):
    jcfg, cfg = configs(which)
    jp = jax_params(jcfg)
    tp = port_params(jp, cfg)
    batch = batches(jcfg, 1)[0]
    jl, jg = jax.jit(jax.value_and_grad(jrecsys.loss_fn), static_argnums=3)(
        jp, jnp.asarray(batch["ids"]), jnp.asarray(batch["labels"]), jcfg)
    loss, grads = TS.xdeepfm_value_and_grad(tp, tb(batch), cfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    assert float(recsys.loss_fn(tp, tb(batch)["ids"], tb(batch)["labels"], cfg)) \
        == float(loss)
    assert_tree_close(grads, flat_np(jg), rtol=1e-5, atol=1e-9)
    # the inputs were not touched and need no gradient
    assert all(not t.requires_grad and t.grad is None for t in tp.values())


@pytest.mark.parametrize("which", ["smoke", "narrow"])
def test_three_train_steps_equal_to_jax(which):
    jcfg, cfg = configs(which)
    jp = jax_params(jcfg)
    tp = port_params(jp, cfg)
    jo, to = jopt.AdamW(jopt.cosine(1e-3, 1, 10)), opt.AdamW(opt.cosine(1e-3, 1, 10))
    jstep = jax.jit(JTS.make_xdeepfm_train_step(jcfg, jo))
    tstep = TS.make_xdeepfm_train_step(cfg, to)
    js, ts = jo.init(jp), to.init(tp)
    for batch in batches(jcfg, 3):
        jp, js, jl = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tl = tstep(tp, ts, tb(batch))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert_tree_close(tp, flat_np(jp), rtol=0, atol=1e-6)
    assert_tree_close(ts.m, flat_np(js.m), rtol=0, atol=1e-6)
    assert int(ts.step) == 3


def test_training_through_the_cin_kernel_raises():
    jcfg, cfg = configs("smoke")
    tp = port_params(jax_params(jcfg), dataclasses.replace(cfg))
    kcfg = dataclasses.replace(cfg, use_cin_kernel=True)
    step = TS.make_xdeepfm_train_step(kcfg, opt.AdamW(opt.constant(1e-3)))
    with pytest.raises(ValueError, match="no backward"):
        step(tp, opt.AdamW(opt.constant(1e-3)).init(tp), tb(batches(jcfg, 1)[0]))
    # serving through the kernel's plain version still runs
    probs = TS.make_xdeepfm_serve_step(kcfg)(tp, tb(batches(jcfg, 1)[0])["ids"])
    assert probs.shape == (B,)


def test_params_keyed_by_jax_paths_frozen_unless_asked():
    cfg = configs("smoke")[1]
    params = recsys.init_params(cfg, seed=1, device="cpu")
    assert list(params) == opt.leaf_order(params) == [
        "bias", "cin/0/w", "cin/1/w", "cin_out", "linear", "mlp/0/b", "mlp/0/w",
        "mlp_out", "table"]
    assert not any(t.requires_grad for t in params.values())
    leaves = {k: t.clone().requires_grad_(True) for k, t in params.items()}
    ids = tb(batches(jget("xdeepfm").make_smoke_config(), 1)[0])
    recsys.loss_fn(leaves, ids["ids"], ids["labels"], cfg).backward()
    assert leaves["table"].grad is not None and leaves["cin/1/w"].grad is not None
    back = convert.xdeepfm_params_to_numpy(params)
    assert [tuple(layer["w"].shape) for layer in back["cin"]] == [
        tuple(params["cin/0/w"].shape), tuple(params["cin/1/w"].shape)]
    again = convert.xdeepfm_params_from_numpy(back, cfg, device="cpu")
    assert list(again) == list(params)
    assert_tree_equal({k: v.numpy() for k, v in again.items()},
                      {k: v.numpy() for k, v in params.items()})


def test_adamw_state_converts_both_ways():
    jcfg, cfg = configs("smoke")
    jp = jax_params(jcfg)
    jo = jopt.AdamW(jopt.cosine(1e-3, 1, 10))
    jstep = jax.jit(JTS.make_xdeepfm_train_step(jcfg, jo))
    js = jo.init(jp)
    for batch in batches(jcfg, 2):
        jp, js, _ = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
    ts = convert.adamw_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert int(ts.step) == 2 and ts.step.dtype == torch.int32
    assert_tree_equal({k: v.numpy() for k, v in ts.v.items()}, flat_np(js.v))
    step, m, v = convert.adamw_state_to_numpy(ts)
    back = jopt.AdamWState(jnp.asarray(step), jax.tree.map(jnp.asarray, m),
                           jax.tree.map(jnp.asarray, v))
    assert jax.tree.structure(back) == jax.tree.structure(js)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def trained_state(n_steps=2):
    """(port params, port AdamW state, JAX params, JAX state) after
    ``n_steps`` identical-input steps of each package."""
    jcfg, cfg = configs("smoke")
    jp = jax_params(jcfg)
    tp = port_params(jp, cfg)
    jo, to = jopt.AdamW(jopt.cosine(1e-3, 1, 10)), opt.AdamW(opt.cosine(1e-3, 1, 10))
    js, ts = jo.init(jp), to.init(tp)
    jstep = jax.jit(JTS.make_xdeepfm_train_step(jcfg, jo))
    tstep = TS.make_xdeepfm_train_step(cfg, to)
    for batch in batches(jcfg, n_steps):
        jp, js, _ = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, _ = tstep(tp, ts, tb(batch))
    return tp, ts, jp, js


def test_checkpoint_roundtrip_retention_and_latest(tmp_path):
    tp, ts, _, _ = trained_state(1)
    d = str(tmp_path / "ck")
    tree = {"params": tp, "opt": ts,
            "extra_bf16": tp["cin/0/w"].to(torch.bfloat16)}
    path = checkpoint.save(d, 7, tree, extra={"note": "x"})
    assert os.path.basename(path) == "step_0000000007"
    restored, manifest = checkpoint.restore(d, tree)
    assert manifest["step"] == 7 and manifest["extra"]["note"] == "x"
    assert manifest["dtypes"]["extra_bf16"] == "bfloat16"
    assert {"params/table", "opt/m/cin/0/w", "opt/step"} <= set(manifest["keys"])
    assert manifest["keys"] == sorted(manifest["keys"])
    assert restored["extra_bf16"].dtype == torch.bfloat16
    assert torch.equal(restored["extra_bf16"], tree["extra_bf16"])
    assert isinstance(restored["opt"], opt.AdamWState)
    for k in tp:
        assert torch.equal(restored["params"][k], tp[k])
        assert torch.equal(restored["opt"].v[k], ts.v[k])
    assert torch.equal(restored["opt"].step, ts.step)
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(d, s, {"p": tp["bias"]}, keep=2)
    assert checkpoint.latest_step(d) == 7
    assert sorted(os.listdir(d)) == ["step_0000000005", "step_0000000007"]
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), tree)
    with pytest.raises(KeyError, match="missing"):
        checkpoint.restore(d, {"q": tp["bias"]})


def test_jax_checkpoint_restored_by_port_bitwise(tmp_path):
    tp, ts, jp, js = trained_state()
    d = str(tmp_path / "jax")
    jckpt.save(d, 2, {"params": jp, "opt": js,
                      "half": jnp.asarray(np.asarray(jp["cin_out"]), jnp.bfloat16)})
    like = {"params": tp, "opt": opt.AdamW(opt.constant(0.0)).init(tp),
            "half": torch.zeros((16 + 16, 1), dtype=torch.bfloat16)}
    got, manifest = checkpoint.restore(d, like)
    assert manifest["step"] == 2
    assert_tree_equal({k: v.numpy() for k, v in got["params"].items()}, flat_np(jp))
    assert_tree_equal({k: v.numpy() for k, v in got["opt"].m.items()}, flat_np(js.m))
    assert int(got["opt"].step) == 2 and got["opt"].step.dtype == torch.int32
    np.testing.assert_array_equal(
        got["half"].float().numpy(),
        np.asarray(jnp.asarray(np.asarray(jp["cin_out"]), jnp.bfloat16), np.float32))


def test_port_checkpoint_restored_by_jax_bitwise(tmp_path):
    tp, ts, jp, js = trained_state()
    d = str(tmp_path / "port")
    checkpoint.save(d, 2, {"params": tp, "opt": ts,
                           "half": tp["cin_out"].to(torch.bfloat16)})
    like = {"params": jp, "opt": js,
            "half": jnp.zeros((32, 1), jnp.bfloat16)}
    got, manifest = jckpt.restore(d, like)
    with open(os.path.join(d, "step_0000000002", "manifest.json")) as f:
        assert json.load(f)["dtypes"]["half"] == "bfloat16"
    assert_tree_equal(flat_np(got["params"]), {k: v.numpy() for k, v in tp.items()})
    assert_tree_equal(flat_np(got["opt"].v), {k: v.numpy() for k, v in ts.v.items()})
    assert int(got["opt"].step) == 2
    np.testing.assert_array_equal(np.asarray(got["half"], np.float32),
                                  tp["cin_out"].to(torch.bfloat16).float().numpy())


def smoke_loop(total, d=None, every=100):
    jcfg, cfg = configs("smoke")
    tp = port_params(jax_params(jcfg), cfg)
    o = opt.AdamW(opt.cosine(1e-3, 2, 6))
    data = batches(jcfg, 6)
    return (LoopConfig(total_steps=total, ckpt_dir=d, ckpt_every=every, log_every=1),
            tp, o.init(tp), TS.make_xdeepfm_train_step(cfg, o), lambda i: tb(data[i]))


def test_run_loop_resume_equals_uninterrupted(tmp_path):
    lc, p0, s0, step, batch_fn = smoke_loop(6)
    p_straight, s_straight, losses = run_loop(lc, p0, s0, step, batch_fn, log=lambda m: None)
    d = str(tmp_path / "loop")
    lc3, p0, s0, _, _ = smoke_loop(3, d, every=3)
    run_loop(lc3, p0, s0, step, batch_fn, log=lambda m: None)
    assert checkpoint.latest_step(d) == 3
    logs = []
    lc6 = dataclasses.replace(lc3, total_steps=6)
    p, s, resumed = run_loop(lc6, p0, s0, step, batch_fn, log=logs.append)
    assert any("resumed from step 3" in m for m in logs)
    assert resumed == losses[3:]
    for k in p:
        assert torch.equal(p[k], p_straight[k]), k
        assert torch.equal(s.m[k], s_straight.m[k]), k
    assert torch.equal(s.step, s_straight.step)
    # a finished run resumes at its end and does nothing more
    logs.clear()
    run_loop(lc6, p0, s0, step, batch_fn, log=logs.append)
    assert any("resumed from step 6" in m for m in logs)


# ---------------------------------------------------------------------------
# Elastic helpers, registry, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [jelastic, elastic], ids=["repro", "repro_torch"])
def test_plan_mesh_and_straggler_policy_like_jax(mod):
    assert mod.plan_mesh(256, model_parallel=16) == (16, 16)
    assert mod.plan_mesh(128, model_parallel=16) == (8, 16)
    assert mod.plan_mesh(24, model_parallel=16)[1] in (1, 2, 4, 8)
    assert mod.plan_mesh(512, model_parallel=16, pods=2) == (2, 16, 16)
    assert mod.plan_mesh(4, model_parallel=4) == (1, 4)
    for n in (1, 6, 24, 96, 100):
        for mp_ in (None, 1, 3, 16):
            assert mod.plan_mesh(n, model_parallel=mp_) == \
                jelastic.plan_mesh(n, model_parallel=mp_)
    pol = mod.StragglerPolicy(quorum_frac=0.75, evict_after=5)
    assert pol.decide(8, 8, 0) == "proceed"
    assert pol.decide(8, 6, 0) == "proceed"
    assert pol.decide(8, 5, 0) == "wait"
    assert pol.decide(8, 5, 5) == "evict"
    ones = torch.ones(4) if mod is elastic else jnp.ones((4,))
    r = mod.StragglerPolicy.rescale({"w": ones}, 8, 6)
    np.testing.assert_allclose(np.asarray(r["w"]), 8 / 6)


def test_reshard_restore_onto_device_and_virtual_mesh(tmp_path):
    tp, _, _, _ = trained_state(1)
    d = str(tmp_path / "el")
    checkpoint.save(d, 1, {"w": tp["mlp/0/w"]})
    tree, _ = elastic.reshard_restore(d, {"w": torch.zeros_like(tp["mlp/0/w"])}, "cpu")
    assert torch.equal(tree["w"], tp["mlp/0/w"])
    mesh = make_mesh((2, 2), ("group", "member"), device="cpu", virtual=True)
    trees, manifest = elastic.reshard_restore(d, {"w": torch.zeros_like(tp["mlp/0/w"])},
                                              mesh)
    assert len(trees) == 4 and all(t is trees[0] for t in trees)
    assert torch.equal(trees[0]["w"], tp["mlp/0/w"]) and manifest["step"] == 1


def test_arch_registry_like_jax():
    from repro.configs import all_cells as jall_cells
    assert all_arch_ids() == ["graph500", "xdeepfm"]
    assert set(all_cells()) <= set(jall_cells())
    assert [c for c in all_cells() if c[0] == "graph500"] == \
        [c for c in jall_cells() if c[0] == "graph500"]
    for make in ("make_config", "make_smoke_config"):
        got = getattr(get("graph500"), make)()
        want = getattr(jget("graph500"), make)()
        assert isinstance(got, pipeline.Graph500Config)
        assert {f: getattr(got, f) for f in ("scale", "n_roots", "engine", "heavy_threshold")} \
            == {f: getattr(want, f) for f in ("scale", "n_roots", "engine", "heavy_threshold")}
    assert get("graph500").shape("bfs_s22").dims == jget("graph500").shape("bfs_s22").dims


def test_launcher_trains_xdeepfm_and_runs_graph500_on_cpu(tmp_path):
    logs = []
    out = launch_train.main(["--arch", "xdeepfm", "--steps", "6", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path / "ck")], log=logs.append)
    assert len(out["losses"]) == 6 and all(np.isfinite(out["losses"]))
    assert checkpoint.latest_step(str(tmp_path / "ck")) == 6
    assert any("done: loss" in m for m in logs)
    again = launch_train.main(["--arch", "xdeepfm", "--steps", "6", "--device", "cpu",
                               "--ckpt-dir", str(tmp_path / "ck")], log=logs.append)
    assert again["losses"] == []
    g = launch_train.main(["--arch", "graph500", "--scale", "8", "--device", "cpu"],
                          log=logs.append)
    assert g["valid"] and g["harmonic_mean_teps"] > 0
    assert any("GTEPS=" in m for m in logs)
