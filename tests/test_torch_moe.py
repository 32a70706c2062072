"""The MoE layer of the PyTorch port (``repro_torch.models.moe``) against
``repro.models.moe`` on the same numpy inputs, on the CPU.

Routing is integer output: ``_route``'s ``slot`` (and with it the drop set)
equals JAX's bit for bit on JAX's float32 logits, ties built on purpose and
capacities that drop included.  ``gate`` and the aux loss are float32
functions of the softmax, and XLA's and torch's float32 softmax differ by
up to 2 ulp on 8-25% of these entries, so from the logits they are held
within rtol 1e-6; from JAX's own softmax probabilities the gate equals
JAX's bit for bit and the aux loss is within 1 ulp (a float32 mean over
the tokens, summed in another order).  Whole-layer
outputs are held within JAX's own MoE tolerance (rtol = atol = 5e-2,
``tests/test_distributed.py``).  The sharded references (``local_tp`` on a
(2, 4) ``("data", "model")`` mesh, the T3 ``monitor_a2a`` dispatch on a
(2, 4) ``("group", "member")`` mesh, and the transformer's forward through
each) come from one subprocess with 8 forced host devices; the port runs
them on virtual meshes.  Every JAX reference is compiled with
``xla_allow_excess_precision`` off (bf16 intermediates rounded, as op by
op).
"""
import dataclasses
import os
import sys
import textwrap

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.models import moe as JM
from repro.util import respawn_with_host_devices
from repro_torch import convert
from repro_torch.comms.mesh import VertexComm, make_mesh
from repro_torch.configs import get
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
NO_EXCESS = {"xla_allow_excess_precision": False}

torch.set_num_threads(2)


def jjit(fn, *args):
    return jax.jit(fn).lower(*args).compile(NO_EXCESS)(*args)


def np32(a) -> np.ndarray:
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a)


def bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np32(a))).to(torch.bfloat16)


def moe_params(jp) -> dict:
    """JAX's ``init_moe`` pytree -> the port's (bf16 weights, float32 router)."""
    return {k: (torch.from_numpy(np.array(np32(v))) if k == "router" else bf16(v))
            for k, v in jp.items()}


def assert_close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(), np32(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def route_logits(case: str) -> tuple[np.ndarray, JM.MoEDims, int]:
    rng = np.random.default_rng(7)
    if case == "random":
        dims = JM.MoEDims(d_model=8, d_ff=8, n_experts=8, top_k=2)
        logits = rng.normal(size=(64, 8)).astype(np.float32)
    elif case == "ties":        # a handful of values: exact ties at the top-k cut
        dims = JM.MoEDims(d_model=8, d_ff=8, n_experts=8, top_k=3)
        logits = rng.integers(0, 3, size=(64, 8)).astype(np.float32)
    elif case == "drops":       # capacity 4 for 32 pairs over 4 experts
        dims = JM.MoEDims(d_model=8, d_ff=8, n_experts=4, top_k=2, capacity_factor=0.25)
        logits = (rng.normal(size=(64, 4)) + np.array([2.0, 0, 0, -1])).astype(np.float32)
    else:                       # top-1, all ties in one row block
        dims = JM.MoEDims(d_model=8, d_ff=8, n_experts=4, top_k=1)
        logits = np.zeros((16, 4), np.float32)
        logits[8:] = rng.normal(size=(8, 4))
    t = logits.shape[0]
    cap = max(1, int(t * dims.top_k * dims.capacity_factor / dims.n_experts))
    return logits, dims, cap


@pytest.mark.parametrize("case", ["random", "ties", "drops", "top1_flat"])
def test_route_equal_to_jax(case):
    logits, dims, cap = route_logits(case)
    jslot, jgate, jaux = jjit(lambda l: JM._route(l, dims, cap), jnp.asarray(logits))
    tdims = M.MoEDims(**dataclasses.asdict(dims))
    slot, gate, aux = M._route(torch.from_numpy(logits), tdims, cap)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # on JAX's softmax probabilities: the gate bit for bit, aux within 1 ulp
    jprobs = jjit(lambda l: jax.nn.softmax(l, axis=-1), jnp.asarray(logits))
    probs = torch.from_numpy(np.array(jprobs))
    pgate, idx = M._top_k(probs, dims.top_k)
    np.testing.assert_array_equal(pgate.reshape(-1).numpy(), np.asarray(jgate))
    np.testing.assert_array_max_ulp(M._aux(probs, idx, dims.n_experts).numpy(),
                                    np.asarray(jaux), maxulp=1)
    drop = dims.n_experts * cap
    kept = slot.numpy() < drop
    assert len(set(slot.numpy()[kept])) == kept.sum()      # unique live slots
    if case == "drops":
        assert (~kept).sum() > 0
    if case in ("ties", "top1_flat"):   # ties at the cut, taken lower index first
        srt = -np.sort(-logits, axis=1)
        assert (srt[:, dims.top_k - 1] == srt[:, dims.top_k]).any()


@pytest.fixture(scope="module")
def dense_case():
    dims = JM.MoEDims(d_model=32, d_ff=64, n_experts=8, top_k=2)
    jp = JM.init_moe(jax.random.PRNGKey(3), dims)
    x = jax.random.normal(jax.random.PRNGKey(5), (2, 16, 32), dtype=jnp.bfloat16)
    return dims, jp, x


@pytest.mark.parametrize("cf", [1.0, 0.25, 8.0])
@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_moe_ffn_equal_to_jax(dense_case, cf, kind):
    dims, jp, x = dense_case
    dims = dataclasses.replace(dims, capacity_factor=cf, mlp_kind=kind)
    if kind == "gelu":
        jp = {k: v for k, v in jp.items() if k != "w_gate"}
    want, jaux = jjit(lambda p, x: JM.moe_ffn(p, x, dims), jp, x)
    tdims = M.MoEDims(**dataclasses.asdict(dims))
    got, aux = M.moe_ffn(moe_params(jp), bf16(x), tdims)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert_close(got, want, 5e-2)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    again, _ = M.moe_ffn(moe_params(jp), bf16(x), tdims)
    assert torch.equal(got, again)
    if cf == 0.25:      # some pairs dropped: a token whose pairs all drop is zero
        assert (got.float().abs().sum(-1) == 0).any()


# ---------------------------------------------------------------------------
# The sharded dispatches against JAX's on 8 forced host devices
# ---------------------------------------------------------------------------

SHARDED_SCRIPT = """
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get
from repro.data.synthetic import lm_batch
from repro.models import moe, transformer as T
from repro.util import make_mesh, shard_map

out = {}
f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
gm = make_mesh((2, 4), ("group", "member"))
dm = make_mesh((2, 4), ("data", "model"))

# T3 monitor dispatch of one layer (tests/test_distributed.py:90), with and
# without drops
for cf in (8.0, 1.0):
    dims = moe.MoEDims(d_model=16, d_ff=32, n_experts=8, top_k=2, capacity_factor=cf)
    p = jax.jit(lambda k, dims=dims: moe.init_moe(k, dims))(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 4, 16), dtype=jnp.bfloat16)

    def local(x, p, dims=dims):
        y, aux = moe.moe_ffn_monitor(p, x, dims, group_axis="group", member_axis="member")
        return y, jax.lax.pmean(aux, ("group", "member"))

    f = jax.jit(shard_map(local, mesh=gm, in_specs=(P(("group", "member")), P()),
                          out_specs=(P(("group", "member")), P()), check=False))
    y, aux = f(x, p)
    tag = f"monitor_{cf}"
    out.update({tag + "_x": f32(x), tag + "_y": f32(y), tag + "_aux": np.asarray(aux)})
    out.update({tag + "_p_" + k: f32(v) for k, v in p.items()})

# the transformer's forward through each dispatch (tests/test_distributed.py:181)
cfg = dataclasses.replace(get("granite-moe-1b-a400m").make_smoke_config(),
                          capacity_factor=16.0)
params = jax.jit(lambda k: T.init_params(k, cfg))(jax.random.PRNGKey(0))
toks = lm_batch(0, 0, 8, 16, cfg.vocab)["tokens"]
pols = {"local_tp": T.ShardingPolicy(mesh=dm, batch_axes=("data",), moe_mode="local_tp",
                                     remat=False),
        "monitor_a2a": T.ShardingPolicy(mesh=gm, batch_axes=("group", "member"),
                                        model_axis=None, moe_mode="monitor_a2a",
                                        remat=False)}
for name, pol in pols.items():
    logits, aux = jax.jit(lambda p, t, pol=pol: T.forward(p, t, cfg, pol))(params, toks)
    out["fwd_" + name] = np.asarray(logits)
    out["fwd_" + name + "_aux"] = np.asarray(aux)
out["fwd_tokens"] = np.asarray(toks)
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["fwd_p_" + "/".join(str(getattr(q, "key", q)) for q in path)] = f32(leaf)
np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_moe") / "out.npz"
    proc = respawn_with_host_devices(
        [sys.executable, "-c", textwrap.dedent(SHARDED_SCRIPT), str(path)], 8,
        extra_env={"JAX_PLATFORMS": "cpu",
                   "XLA_FLAGS": "--xla_force_host_platform_device_count=8 "
                                "--xla_allow_excess_precision=false"},
        pythonpath=(REPO_SRC,), capture=True, timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    return dict(np.load(path))


def params_of(ref: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_monitor_dispatch_equal_to_jax_sharded(jax_sharded, cf):
    tag = f"monitor_{cf}"
    dims = M.MoEDims(d_model=16, d_ff=32, n_experts=8, top_k=2, capacity_factor=cf)
    p = moe_params(params_of(jax_sharded, tag + "_p_"))
    x = bf16(jax_sharded[tag + "_x"])
    comm = VertexComm(make_mesh((2, 4), ("group", "member"), device="cpu", virtual=True))
    outs, auxes = M.moe_ffn_monitor(p, list(x.chunk(8)), dims, comm=comm)
    got = torch.cat(outs)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert_close(got, jax_sharded[tag + "_y"], 5e-2)
    np.testing.assert_allclose(float(torch.stack(auxes).mean()),
                               float(jax_sharded[tag + "_aux"]), rtol=1e-5)
    if cf == 8.0:       # no drops: the dense layer on each shard's tokens
        dense = torch.cat([M.moe_ffn(p, xx, dims)[0] for xx in x.chunk(8)])
        assert_close(got, dense.float().numpy(), 5e-2)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_local_tp_dispatch_equal_to_dense(dense_case, cf):
    """local_tp keeps the pairs the dense layer keeps (each expert's
    capacity and order are the same), so on each data shard it equals JAX's
    dense layer on that shard's tokens, drops included."""
    dims, jp, x = dense_case
    dims = dataclasses.replace(dims, top_k=4, capacity_factor=cf)
    tdims = M.MoEDims(**dataclasses.asdict(dims))
    p = moe_params(jp)
    outs, auxes = zip(*(M.moe_ffn_local_tp(p, xx, tdims, model_shards=4)
                        for xx in bf16(x).chunk(2)))
    want = jjit(lambda p, x: [JM.moe_ffn(p, x[i:i + 1], dims) for i in range(2)], jp, x)
    assert_close(torch.cat(outs), np.concatenate([np32(w) for w, _ in want]), 5e-2)
    for a, (_, ja) in zip(auxes, want):
        np.testing.assert_allclose(float(a), float(ja), rtol=1e-5)
    with pytest.raises(ValueError, match="do not split"):
        M.moe_ffn_local_tp(p, bf16(x), tdims, model_shards=3)


@pytest.mark.parametrize("mode", ["local_tp", "monitor_a2a"])
def test_forward_through_each_dispatch_equal_to_jax(jax_sharded, mode):
    cfg = dataclasses.replace(get("granite-moe-1b-a400m").make_smoke_config(),
                              capacity_factor=16.0)
    tree = convert.tree_from_paths(params_of(jax_sharded, "fwd_p_"))
    params = convert.lm_params_from_numpy(tree, cfg, device="cpu")
    if mode == "local_tp":
        pol = T.ShardingPolicy(mesh=make_mesh((2, 4), ("data", "model"), device="cpu",
                                              virtual=True), moe_mode=mode, remat=False)
    else:
        pol = T.ShardingPolicy(mesh=make_mesh((2, 4), ("group", "member"), device="cpu",
                                              virtual=True),
                               batch_axes=("group", "member"), model_axis=None,
                               moe_mode=mode, remat=False)
    toks = torch.from_numpy(jax_sharded["fwd_tokens"].copy())
    with torch.no_grad():
        logits, aux = T.forward(params, toks, cfg, pol)
        dense, _ = T.forward(params, toks, cfg, T.ShardingPolicy(remat=False))
    # the logits within 5e-2 x max |logit| of JAX's sharded forward and of
    # the port's dense one; the aux loss (the top-1 fractions, which a near
    # tie moves by 1/64 a token) within 5e-2 of JAX's
    want = jax_sharded["fwd_" + mode]
    assert np.abs(logits.numpy() - want).max() <= 5e-2 * np.abs(want).max()
    assert (logits - dense).abs().max() <= 5e-2 * dense.abs().max()
    np.testing.assert_allclose(float(aux), float(jax_sharded[f"fwd_{mode}_aux"]),
                               rtol=5e-2)


def test_sharded_dispatch_rejects_bad_meshes():
    cfg = get("granite-moe-1b-a400m").make_smoke_config()
    params = T.init_params(cfg, device="cpu")
    toks = torch.zeros((8, 4), dtype=torch.int32)
    wrong = T.ShardingPolicy(mesh=make_mesh((2, 4), ("data", "model"), device="cpu",
                                            virtual=True),
                             batch_axes=("data",), moe_mode="monitor_a2a")
    with pytest.raises(ValueError, match="monitor_a2a needs"):
        T.forward(params, toks, cfg, wrong)
    odd = T.ShardingPolicy(mesh=make_mesh((2, 4), ("group", "member"), device="cpu",
                                          virtual=True),
                           batch_axes=("group", "member"), moe_mode="monitor_a2a")
    with pytest.raises(ValueError, match="does not split"):
        T.forward(params, toks[:6], cfg, odd)
