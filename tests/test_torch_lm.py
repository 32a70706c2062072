"""The LM stack of the PyTorch port (``repro_torch.models.{layers,
transformer}``, the LM train / serve / prefill steps, ``lm_batch``, the
launcher's LM branch, ``convert.lm_params_*``) against ``repro`` on the same
numpy inputs, on the CPU at the smoke configs; and ``core.run_graph500``.

The JAX parameters and batches (``jax.random`` cannot be replayed in torch)
are carried across with ``convert.lm_params_from_numpy``.  Every JAX
reference is compiled with ``xla_allow_excess_precision`` off
(:func:`jjit`), which gives JAX's op-by-op results bit for bit at jit's
speed: by default XLA's fusions keep bf16 intermediates in float32, which
moves JAX's own moonshot-smoke logits by 0.17 x max |logit| through one
routing flip.  Tolerances are the JAX package's own tests' (``tests/test_models.py``):
1e-2 for chunked attention, 3e-2 for decode against forward; logits within
3e-2 x max |logit| (random-init activations make an absolute tolerance
vacuous), gradients within 3e-2 of each leaf's largest |gradient| (bf16).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import all_arch_ids as jall_arch_ids, get as jget
from repro.core import kronecker as jkron
from repro.core import pipeline as jpipe
from repro.core import teps as jteps
from repro.core.plan import BFSPlan as JBFSPlan, PreparedGraph as JPrepared
from repro.core.plan import compile_plan as jcompile
from repro.data import synthetic as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW, constant as jconstant
from repro.train import checkpoint as jckpt
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.configs import base as cbase
from repro_torch.configs import all_arch_ids, get, lm_archs
from repro_torch.core import run_graph500
from repro_torch.core.plan import BFSPlan, PreparedGraph, compile_plan
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import AdamW, constant
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as TS

torch.set_num_threads(2)

LM_ARCHS = ["granite-moe-1b-a400m", "minicpm-2b", "moonshot-v1-16b-a3b", "olmo-1b",
            "starcoder2-15b"]
BATCH, SEQ = 2, 16


def xla(fn, *args):
    """``fn`` compiled for ``args``' shapes by XLA with
    ``xla_allow_excess_precision`` off: every bf16 intermediate rounded, as
    op by op."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})


def jjit(fn, *args):
    return xla(fn, *args)(*args)


def np32(a) -> np.ndarray:
    """A JAX array as numpy: floats as float32 (bf16 values exact)."""
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a)


def tt(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(np32(a)))
    return t if dtype is None else t.to(dtype)


def assert_rel(got: torch.Tensor, want, tol: float, what: str = ""):
    want = np32(want)
    got = got.detach().float().numpy()
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * top, f"{what}: max |diff| {err} > {tol} x max |ref| {top}"


def smoke(arch: str, **kw):
    jcfg = dataclasses.replace(jget(arch).make_smoke_config(), **kw)
    return jcfg, dataclasses.replace(get(arch).make_smoke_config(), **kw)


class Refs:
    """JAX's smoke parameters, batch and reference outputs, per arch, made
    once for the module."""

    def __init__(self):
        self._memo = {}

    def get(self, arch: str, **kw):
        key = (arch, tuple(sorted(kw.items())))
        if key not in self._memo:
            jcfg, cfg = smoke(arch, **kw)
            jp = jjit(lambda key: JT.init_params(key, jcfg), jax.random.PRNGKey(0))
            batch = JS.lm_batch(0, 0, BATCH, SEQ, jcfg.vocab)
            logits, aux = jjit(lambda p, t: JT.forward(p, t, jcfg), jp, batch["tokens"])
            self._memo[key] = dict(
                jcfg=jcfg, cfg=cfg, jp=jp, batch=batch, logits=logits, aux=aux,
                params=convert.lm_params_from_numpy(jax.tree.map(np32, jp), cfg,
                                                    device="cpu"),
                tokens=tt(batch["tokens"]), labels=tt(batch["labels"]))
        return self._memo[key]


@pytest.fixture(scope="module")
def refs():
    return Refs()


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def layer_input(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_norms_equal_to_jax(kind):
    x = layer_input((3, 5, 64)) * 2 + 0.5
    rng = np.random.default_rng(1)
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    p = {"rmsnorm": {"scale": p["scale"]}, "layernorm": p, "nonparametric_ln": {}}[kind]
    want = JL.apply_norm(kind, jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    got = L.apply_norm(kind, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), np32(want), rtol=1e-5, atol=1e-5)
    assert set(L.init_norm(kind, 64)) == set(JL.init_norm(kind, 64))


def test_rope_equal_to_jax_and_relative_shift():
    x = layer_input((2, 6, 3, 16), seed=8)
    pos = np.stack([np.arange(6), np.arange(6) * 7 + 1000])
    for theta in (10000.0, 100000.0):
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        np.testing.assert_allclose(got.numpy(), np32(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(L.rope_freqs(24).numpy(), np32(JL.rope_freqs(24)),
                               rtol=1e-6)
    # JAX's property test: a rotation, and inner products depend only on the
    # relative distance (tests/test_models.py:124)
    x1 = torch.from_numpy(layer_input((1, 6, 1, 8), seed=9))
    p0 = torch.arange(6)[None]
    r0 = L.apply_rope(x1, p0)
    np.testing.assert_allclose(np.linalg.norm(r0.numpy()), np.linalg.norm(x1.numpy()),
                               rtol=1e-5)
    r100 = L.apply_rope(x1, p0 + 100)
    q = r0.numpy()[0, :, 0]
    k = r100.numpy()[0, :, 0]
    np.testing.assert_allclose(q[0] @ q[3], k[0] @ k[3], rtol=1e-4)


ATTN_CASES = [(None, None), (None, 8), (None, 16), (None, 32), (8, None), (8, 16)]


@pytest.fixture(scope="module")
def attn_case():
    """JAX's attention (d 64, 8 heads over 2 KV heads) on [2, 64, 64] bf16,
    for every (window, q_chunk) of ATTN_CASES, from one compile."""
    dims = JL.AttnDims(d_model=64, n_heads=8, n_kv_heads=2, head_dim=8)
    jp = JL.init_attention(jax.random.PRNGKey(10), dims)
    x = jax.random.normal(jax.random.PRNGKey(11), (2, 64, 64), dtype=jnp.bfloat16)
    p = {k: tt(v, torch.bfloat16) for k, v in jp.items()}
    outs = jjit(lambda p, x: [JL.attention(p, x, dims, window=w, q_chunk=c)
                              for w, c in ATTN_CASES], jp, x)
    return dims, jp, x, p, tt(x, torch.bfloat16), dict(zip(ATTN_CASES, outs))


@pytest.mark.parametrize("window,q_chunk", ATTN_CASES)
def test_attention_equal_to_jax(attn_case, window, q_chunk):
    dims, jp, x, p, xt, refs_ = attn_case
    tdims = L.AttnDims(**dataclasses.asdict(dims))
    want = refs_[(window, q_chunk)]
    got = L.attention(p, xt, tdims, window=window, q_chunk=q_chunk)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 64, 64)
    np.testing.assert_allclose(got.float().numpy(), np32(want), rtol=1e-2, atol=1e-2)
    # exact chunking: the chunked port equals the unchunked port
    full = L.attention(p, xt, tdims, window=window)
    np.testing.assert_allclose(got.float().numpy(), full.float().numpy(),
                               rtol=1e-2, atol=1e-2)


def test_decode_attention_and_mlp_equal_to_jax(attn_case):
    dims, jp, x, p, xt, _ = attn_case
    tdims = L.AttnDims(**dataclasses.asdict(dims))
    rng = np.random.default_rng(4)
    ck = rng.normal(size=(2, 12, 2, 8)).astype(np.float32)
    cv = rng.normal(size=(2, 12, 2, 8)).astype(np.float32)
    xj = x[:, 5:6]
    jck, jcv = jnp.asarray(ck, jnp.bfloat16), jnp.asarray(cv, jnp.bfloat16)
    jdec = {w: xla(lambda p, x, k, v, pos: JL.decode_attention(p, x, k, v, pos, dims, window=w),
                   jp, xj, jck, jcv, jnp.int32(0)) for w in (None, 4)}
    for pos, window in ((5, None), (9, None), (9, 4), (11, None)):
        want, wk, wv = jdec[window](jp, xj, jck, jcv, jnp.int32(pos))
        tk, tv = tt(ck, torch.bfloat16), tt(cv, torch.bfloat16)
        got, gk, gv = L.decode_attention(p, xt[:, 5:6], tk, tv, pos, tdims, window=window)
        assert gk is tk and gv is tv          # the cache is written in place
        np.testing.assert_allclose(got.float().numpy(), np32(want), rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(gk.float().numpy(), np32(wk), rtol=1e-2, atol=1e-2)
        np.testing.assert_array_equal(gv.float().numpy(), np32(wv))
    for kind in ("gelu", "swiglu"):
        jm = JL.init_mlp(jax.random.PRNGKey(12), 64, 96, kind)
        want = jjit(lambda p, x: JL.mlp(p, x, kind), jm, x)
        got = L.mlp({k: tt(v, torch.bfloat16) for k, v in jm.items()}, xt, kind)
        assert set(L.init_mlp(torch.Generator().manual_seed(0), 64, 96, kind)) == set(jm)
        np.testing.assert_allclose(got.float().numpy(), np32(want), rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# The model: forward, decode, greedy serving, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_equal_to_jax(refs, arch):
    r = refs.get(arch)
    logits, aux = T.forward(r["params"], r["tokens"], r["cfg"])
    assert logits.dtype == torch.float32
    assert logits.shape == (BATCH, SEQ, r["cfg"].vocab)
    assert_rel(logits, r["logits"], 3e-2, f"{arch} logits")
    assert abs(float(aux) - float(r["aux"])) <= 1e-3, (float(aux), float(r["aux"]))
    # prefill contracts only the last row: the forward's hidden state there
    # through the same head, bit for bit; against the forward's last row the
    # float32 sums run in another order (another GEMM shape)
    last = TS.make_lm_prefill(r["cfg"])(r["params"], r["tokens"])
    x, _ = T.hidden_states(r["params"], r["tokens"], r["cfg"])
    assert torch.equal(last, T.final_logits(r["params"], x[:, -1], r["cfg"]))
    assert_rel(last, logits[:, -1], 1e-6, f"{arch} prefill against the forward")


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m"])
def test_decode_matches_forward_and_jax(refs, arch):
    """Teacher-forced decode reproduces the full forward (the JAX package's
    test, tests/test_models.py:38), with MoE capacity large enough that
    neither form drops a token; and each step equals JAX's decode."""
    kw = dict(capacity_factor=16.0) if arch.startswith("granite") else {}
    r = refs.get(arch, **kw)
    jcfg, cfg = r["jcfg"], r["cfg"]
    jcache = JT.init_cache(jcfg, BATCH, SEQ)
    jdec = xla(lambda p, c, t, pos: JT.decode_step(p, c, t, pos, jcfg), r["jp"], jcache,
               r["batch"]["tokens"][:, :1], jnp.int32(0))
    cache = T.init_cache(cfg, BATCH, SEQ, device="cpu")
    outs = []
    with torch.no_grad():
        for t in range(SEQ):
            jl, jcache = jdec(r["jp"], jcache, r["batch"]["tokens"][:, t:t + 1], jnp.int32(t))
            lg, cache2 = T.decode_step(r["params"], cache, r["tokens"][:, t:t + 1], t, cfg)
            assert cache2 is cache
            assert_rel(lg, jl, 3e-2, f"{arch} decode step {t}")
            outs.append(lg)
        full, _ = T.forward(r["params"], r["tokens"], cfg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=3e-2, atol=3e-2)
    assert_rel(cache["k"], jcache["k"], 3e-2, "cache k")


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m"])
def test_greedy_tokens_equal_to_jax(refs, arch):
    """JAX generates greedily from a 4-token prompt; the port's serve step,
    fed JAX's stream, picks JAX's token wherever JAX's top-2 logit gap is
    above the tolerance (3e-2 x max |logit|)."""
    r = refs.get(arch)
    jcfg, cfg = r["jcfg"], r["cfg"]
    prompt, steps = 4, 12
    jcache = JT.init_cache(jcfg, BATCH, prompt + steps)
    tok = r["batch"]["tokens"][:, :1]
    jstep = xla(JTS.make_lm_serve_step(jcfg), r["jp"], jcache, tok, jnp.int32(0))
    jdec = xla(lambda p, c, t, pos: JT.decode_step(p, c, t, pos, jcfg)[0], r["jp"], jcache,
               tok, jnp.int32(0))
    step = TS.make_lm_serve_step(cfg)
    cache = T.init_cache(cfg, BATCH, prompt + steps, device="cpu")
    checked = 0
    for t in range(prompt + steps - 1):
        jl = jdec(r["jp"], jcache, tok, jnp.int32(t))
        jnext, jcache = jstep(r["jp"], jcache, tok, jnp.int32(t))
        nxt, cache = step(r["params"], cache, tt(tok), t)
        assert nxt.dtype == torch.int32 and nxt.shape == (BATCH, 1)
        top2 = np.sort(np32(jl), -1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 3e-2 * np.abs(np32(jl)).max()
        np.testing.assert_array_equal(nxt.numpy()[clear, 0], np.asarray(jnext)[clear, 0])
        checked += int(clear.sum())
        tok = r["batch"]["tokens"][:, t + 1:t + 2] if t + 1 < prompt else jnext
    assert checked >= BATCH * (prompt + steps - 1) // 2


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_grads(refs):
    memo = {}

    def get_(arch):
        if arch not in memo:
            r = refs.get(arch)
            memo[arch] = jjit(jax.value_and_grad(JTS.make_lm_loss(r["jcfg"])),
                              r["jp"], r["batch"])
        return memo[arch]
    return get_


@pytest.mark.parametrize("arch", ["olmo-1b", "starcoder2-15b", "granite-moe-1b-a400m"])
def test_value_and_grad_equal_to_jax(refs, jax_grads, arch):
    r = refs.get(arch)
    jloss, jgrads = jax_grads(arch)
    batch = {"tokens": r["tokens"], "labels": r["labels"]}
    loss, grads = TS.lm_value_and_grad(r["params"], batch, r["cfg"])
    assert abs(float(loss) - float(jloss)) <= 1e-2, (float(loss), float(jloss))
    flat = convert.paths_from_tree(jgrads)
    assert set(grads) == set(flat) == set(r["params"])
    for k, g in grads.items():
        assert g.dtype == r["params"][k].dtype and g.shape == r["params"][k].shape, k
        assert_rel(g, flat[k], 3e-2, f"{arch} grad {k}")


def test_train_step_equal_to_jax(refs, jax_grads):
    """One AdamW(constant(1e-3)) step: the loss, the first moments (the
    clipped gradients) within the gradient tolerance, and every parameter
    within two learning rates (a first Adam step moves an element by ~lr x
    sign(g), and an element whose gradient is ~0 may take either sign)
    plus one bf16 ulp."""
    r = refs.get("olmo-1b")
    jopt, opt = JAdamW(jconstant(1e-3)), AdamW(constant(1e-3))
    jnew, jstate, jloss = jjit(JTS.make_lm_train_step(r["jcfg"], jopt),
                               r["jp"], jopt.init(r["jp"]), r["batch"])
    step = TS.make_lm_train_step(r["cfg"], opt)
    new, state, loss = step(r["params"], opt.init(r["params"]),
                            {"tokens": r["tokens"], "labels": r["labels"]})
    assert abs(float(loss) - float(jloss)) <= 1e-2
    assert int(state.step) == int(jstate.step) == 1
    jm, jnew = convert.paths_from_tree(jstate.m), convert.paths_from_tree(jnew)
    for k, p in new.items():
        assert p.dtype == r["params"][k].dtype
        assert_rel(state.m[k], jm[k], 3e-2, f"m {k}")
        old = np32(r["params"][k].float())
        want = np32(jnew[k])
        assert np.all(np.abs(p.float().numpy() - want)
                      <= 2.2e-3 + 2.0 ** -7 * np.abs(old)), k


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m"])
def test_remat_gives_the_same_bits(refs, arch):
    r = refs.get(arch)
    batch = {"tokens": r["tokens"], "labels": r["labels"]}
    l1, g1 = TS.lm_value_and_grad(r["params"], batch, r["cfg"], T.ShardingPolicy(remat=True))
    l2, g2 = TS.lm_value_and_grad(r["params"], batch, r["cfg"], T.ShardingPolicy(remat=False))
    assert torch.equal(l1, l2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


# ---------------------------------------------------------------------------
# Configs, checkpoints, data, the launcher
# ---------------------------------------------------------------------------

def test_param_counts_and_registry_equal_to_jax():
    assert sorted(a for a in jall_arch_ids() if jget(a).family == "lm") == LM_ARCHS
    assert all_arch_ids() == sorted(jall_arch_ids())   # every family is ported
    for arch in LM_ARCHS:
        spec, jspec = get(arch), jget(arch)
        assert spec.family == "lm" and spec.shapes == cbase.LM_SHAPES
        assert [dataclasses.asdict(s) for s in spec.shapes] == \
            [dataclasses.asdict(s) for s in jspec.shapes]
        assert (spec.source, spec.notes) == (jspec.source, jspec.notes)
        for make in ("make_config", "make_smoke_config"):
            cfg, jcfg = getattr(spec, make)(), getattr(jspec, make)()
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            assert cfg.param_count() == jcfg.param_count()
            assert cfg.active_param_count() == jcfg.active_param_count()
            padded = lm_archs.padded_vocab(cfg)
            assert padded.vocab % 16 == 0 and padded.vocab - cfg.vocab < 16
        # the smoke parameters hold param_count weights beside the norms
        smoke_p = T.init_params(spec.make_smoke_config(), device="cpu")
        n = sum(v.numel() for k, v in smoke_p.items() if "norm" not in k)
        assert n == spec.make_smoke_config().param_count()
    assert get("olmo-1b").make_config().param_count() == 1_176_764_416


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_and_shardings_mirror_jax(refs, arch):
    r = refs.get(arch)
    jcfg, cfg = r["jcfg"], r["cfg"]
    jflat = convert.paths_from_tree(r["jp"])
    p = T.init_params(cfg, seed=3, device="cpu")
    assert list(p) == list(r["params"])
    for k, v in p.items():
        assert tuple(v.shape) == tuple(jflat[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(jflat[k].dtype), k
        if k == "embed":        # JAX's N(0, 0.02^2)
            assert abs(float(v.float().std()) - 0.02) < 2e-3
    assert torch.equal(T.init_params(cfg, seed=3, device="cpu")["embed"], p["embed"])
    from repro.util import make_mesh
    for policy in (T.ShardingPolicy(), T.ShardingPolicy(model_axis=None)):
        jmesh = make_mesh((1, 1), ("data", "model"))
        jpol = JT.ShardingPolicy(mesh=jmesh, model_axis=policy.model_axis)
        want = {k: tuple(v.spec) for k, v in
                convert.paths_from_tree(JT.param_shardings(jcfg, jpol)).items()}
        got = T.param_shardings(cfg, policy)
        assert set(got) == set(p)
        assert {k: tuple(v) + (None,) * (len(p[k].shape) - len(v))
                for k, v in got.items()} == \
            {k: v + (None,) * (len(p[k].shape) - len(v)) for k, v in want.items()}
        for seq in (False, True):
            jc = JT.cache_shardings(jcfg, jpol, shard_seq=seq)
            assert T.cache_shardings(cfg, policy, shard_seq=seq) == \
                {k: tuple(v.spec) for k, v in jc.items()}


def test_checkpoint_restores_in_both_packages(tmp_path, refs):
    r = refs.get("granite-moe-1b-a400m")
    jckpt.save(str(tmp_path / "jax"), 3, {"params": r["jp"]})
    got, manifest = ckpt.restore(str(tmp_path / "jax"), {"params": r["params"]})
    assert manifest["step"] == 3
    for k, v in r["params"].items():
        assert got["params"][k].dtype == v.dtype and torch.equal(got["params"][k], v), k
    p = T.init_params(r["cfg"], seed=5, device="cpu")
    ckpt.save(str(tmp_path / "torch"), 4, {"params": p})
    back, _ = jckpt.restore(str(tmp_path / "torch"), {"params": r["jp"]})
    flat = convert.paths_from_tree(back["params"])
    for k, v in p.items():
        assert str(flat[k].dtype) == str(v.dtype).split(".")[-1], k
        np.testing.assert_array_equal(np32(flat[k]), v.float().numpy())
    # and the numpy carriers both ways: the port's parameters as JAX's
    again = convert.lm_params_from_numpy(convert.lm_params_to_numpy(p), r["cfg"],
                                         device="cpu")
    assert all(torch.equal(again[k], p[k]) for k in p)
    bits = convert.lm_params_from_numpy(
        {"embed": np.asarray(r["jp"]["embed"]).view(np.uint16),
         **{k: v for k, v in jax.tree.map(np32, r["jp"]).items() if k != "embed"}},
        r["cfg"], device="cpu")
    assert torch.equal(bits["embed"], r["params"]["embed"])
    with pytest.raises(ValueError, match="not exactly"):
        convert.lm_params_from_numpy(
            {**jax.tree.map(np32, r["jp"]),
             "embed": np32(r["jp"]["embed"]) + np.float32(1e-6)}, r["cfg"], device="cpu")


def test_lm_batch_stream():
    a = lm_batch(0, 3, 4, 32, 512, device="cpu")
    b = lm_batch(0, 3, 4, 32, 512, device="cpu")
    c = lm_batch(0, 4, 4, 32, 512, device="cpu")
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (4, 32)
    assert torch.equal(a["tokens"], b["tokens"]) and not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    big = lm_batch(1, 0, 64, 256, 512, device="cpu")["tokens"]
    assert int(big.min()) >= 0 and int(big.max()) == 511      # clipped tail
    counts = torch.bincount(big.reshape(-1).long(), minlength=512).numpy()
    # the truncated Zipf(1.1): P(id = 0) = 1 - 2^-1.1 (~0.53), then falling
    assert abs(counts[0] / big.numel() - (1 - 2 ** -1.1)) < 0.01
    assert counts[0] > counts[1] > counts[2] > counts[8]


@pytest.mark.parametrize("arch", ["olmo-1b", "minicpm-2b"])
def test_launcher_lm_branch(arch, tmp_path):
    lines = []
    out = launch_train.main(["--arch", arch, "--steps", "4", "--seq", "16",
                             "--device", "cpu", "--ckpt-dir", str(tmp_path)],
                            log=lines.append)
    losses = out["losses"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert abs(losses[0] - np.log(512)) < 1.0        # ~ln(vocab) at random init
    assert "family=lm" in lines[0] and lines[-1].startswith("[train] done")
    # wsd for minicpm-2b (warmup 5, stable max(4 - 15, 5)), cosine otherwise
    again = launch_train.main(["--arch", arch, "--steps", "4", "--seq", "16",
                               "--device", "cpu", "--ckpt-dir", str(tmp_path)],
                              log=lines.append)
    assert again["losses"] == [] and "resumed from step 4" in "".join(lines)


# ---------------------------------------------------------------------------
# core.run_graph500 (the per-root timed harness)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def g500_scale10():
    cfg = jpipe.Graph500Config(scale=10, edge_factor=16, seed=2)
    built = jpipe.build(cfg)
    edges = jkron.generate_edges(cfg.seed, 10, 16)
    roots = np.asarray(built.reorder.new_from_old[jkron.sample_roots(cfg.seed, edges, 4)])
    return built, roots


@pytest.mark.parametrize("engine,do_validate", [("reference", True), ("reference", False),
                                                ("bitmap", True)])
def test_run_graph500_equal_to_jax(g500_scale10, engine, do_validate):
    jb, roots = g500_scale10
    core = None
    a_core = k_heavy = None
    if engine == "bitmap":
        a_core, k_heavy = np.asarray(jb.core.a_core), int(jb.core.k_heavy)
    built = convert.built_from_numpy(
        np.asarray(jb.ev.src), np.asarray(jb.ev.dst), np.asarray(jb.ev.valid),
        np.asarray(jb.degree), num_vertices=jb.n_vertices, a_core=a_core,
        k_heavy=k_heavy, threshold=jb.core.threshold if a_core is not None else 100,
        device="cpu")
    core = built.core
    jrun = jteps.run_graph500(jb.ev, jb.degree, roots, core=jb.core if core else None,
                              engine=engine, do_validate=do_validate)
    run = run_graph500(built.ev, built.degree, roots, core=core, engine=engine,
                       do_validate=do_validate, device="cpu")
    assert run.edges == [int(e) for e in jrun.edges]
    assert run.validated == jrun.validated == [True] * len(roots)
    assert len(run.teps) == len(roots) and run.harmonic_mean_teps > 0 and not run.batched
    # the parents of the same per-root plan, bit for bit
    jparents = jcompile(JBFSPlan(engine=engine, layout=(), batch_roots=False),
                        JPrepared(ev=jb.ev, degree=jb.degree,
                                  core=jb.core if core else None)).run(
        roots, do_validate=False).parent
    parents = compile_plan(BFSPlan(engine=engine, layout=(), batch_roots=False),
                           PreparedGraph(ev=built.ev, degree=built.degree, core=core),
                           device="cpu").run(roots, do_validate=False).parent
    np.testing.assert_array_equal(parents, np.asarray(jparents))
