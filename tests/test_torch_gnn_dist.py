"""The owner-partitioned GraphSAGE step of the PyTorch port
(``repro_torch.models.gnn_dist``) against the JAX package.

On virtual ``(group, member)`` meshes of the CPU, hierarchical (the T3
monitor all-gather) and flat, the port's step equals JAX's single-device
``make_gnn_train_step("sage")`` at JAX's own bound (``tests/test_distributed.py``):
the loss within 1e-4 and every parameter within 1e-5 after one AdamW step;
its gradients equal the port's single-device ones within 1e-5 x each leaf's
largest |gradient| (the gradient of the global mean NLL; JAX's own step
hands AdamW P times that, which its first step hides).  The edge partition
is the JAX test's, bit for bit.  With ``gather_dtype=bfloat16`` the port's
step is held against JAX's ``make_sage_dist_step`` itself on 8 forced host
devices (one subprocess for the module; JAX compiled with
``xla_allow_excess_precision`` off, so every bf16 intermediate is rounded as
the port rounds it) at :data:`BF16_LOSS_TOL` and :data:`BF16_PARAM_TOL`.
"""
import os
import sys
import textwrap

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get as jget
from repro.data.graphs import make_feature_graph as jmake_feature_graph
from repro.models import gnn as jgnn
from repro.optim import AdamW as JAdamW, constant as jconstant
from repro.train.train_step import make_gnn_train_step as jmake_gnn_train_step
from repro.util import respawn_with_host_devices
from repro_torch import convert
from repro_torch.comms.mesh import make_mesh
from repro_torch.configs import get
from repro_torch.models import gnn_dist
from repro_torch.optim import AdamW, constant
from repro_torch.train import train_step as TS

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")

torch.set_num_threads(2)

#: bf16 step against JAX's bf16 step.  Both round every bf16 intermediate,
#: but the products and the segment sums (bf16 accumulators, one rounding an
#: edge) run in another order, so a logit moves by a few bf16 ulps (2^-8
#: relative).  Measured at this size: the losses 1.9e-4 apart, the
#: parameters 3.2e-7 after one AdamW step (JAX's float32 bound holds).
BF16_LOSS_TOL = 1e-3
BF16_PARAM_TOL = 1e-5
#: bf16 step against the float32 step, relative to the float32 loss: another
#: function (a bf16 count stalls at 256 edges), held loosely; 1.3e-4 here.
BF16_VS_F32_REL = 5e-2
SCALE = 9


def partition_like_jax(src, dst, valid, n, p):
    """The edge partition of ``tests/test_distributed.py``, in numpy."""
    n_loc = n // p
    owner = np.where(valid, dst // n_loc, p)
    order = np.argsort(owner, kind="stable")
    src_s, dst_s = src[order], dst[order]
    counts = np.bincount(owner[valid], minlength=p)
    cap = ((counts.max() + 127) // 128) * 128
    s = np.full((p, cap), n, np.int32)
    d = np.zeros((p, cap), np.int32)
    v = np.zeros((p, cap), bool)
    pos = 0
    for pe in range(p):
        k = counts[pe]
        s[pe, :k] = src_s[pos:pos + k]
        d[pe, :k] = dst_s[pos:pos + k] % n_loc
        v[pe, :k] = True
        pos += k
    return s.reshape(-1), d.reshape(-1), v.reshape(-1)


_SETUP: dict = {}


def setup():
    """JAX's graph, labels and parameters, the single-device AdamW step of
    both packages, and the port's copies (built once)."""
    if not _SETUP:
        cfg, jcfg = get("graphsage-reddit").make_smoke_config(), \
            jget("graphsage-reddit").make_smoke_config()
        jg, jlabels = jmake_feature_graph(0, SCALE, d_feat=jcfg.d_in,
                                          n_classes=jcfg.n_classes, edge_factor=4)
        jp = jgnn.sage_init(jax.random.PRNGKey(0), jcfg)
        jopt = JAdamW(jconstant(1e-3))
        jnew, _, jloss = jax.jit(jmake_gnn_train_step("sage", jcfg, jopt))(
            jp, jopt.init(jp), jg, jlabels)
        src, dst, valid = (np.asarray(jg.edge_src), np.asarray(jg.edge_dst),
                           np.asarray(jg.edge_valid))
        g = convert.graph_from_numpy(np.asarray(jg.node_feat), src, dst, valid,
                                     jg.n_nodes, device="cpu")
        params = convert.gnn_params_from_numpy(jax.tree.map(np.asarray, jp),
                                               "graphsage-reddit", cfg, device="cpu")
        _SETUP.update(cfg=cfg, g=g, labels=torch.from_numpy(np.array(jlabels)),
                      params=params, jloss=float(jloss),
                      jnew=convert.paths_from_tree(jax.tree.map(np.asarray, jnew)),
                      arrays=(np.asarray(jg.node_feat), src, dst, valid, np.asarray(jlabels)),
                      jp=jax.tree.map(np.asarray, jp))
    return _SETUP


class Capture:
    """An optimizer whose update hands back the gradients as the state."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        return params, grads


def dist_inputs(g, n_shards):
    return gnn_dist.partition_edges(g.edge_src, g.edge_dst, g.edge_valid, g.n_nodes,
                                    n_shards)


def test_partition_matches_the_jax_test_bit_for_bit():
    s = setup()
    _, src, dst, valid, _ = s["arrays"]
    for p in (1, 4, 8):
        got = dist_inputs(s["g"], p)
        for a, b in zip(got, partition_like_jax(src, dst, valid, s["g"].n_nodes, p)):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("shape", [(2, 4), (2, 2)])
@pytest.mark.parametrize("hierarchical", [True, False])
def test_dist_step_matches_single_device(shape, hierarchical):
    s = setup()
    cfg, g, labels, params = s["cfg"], s["g"], s["labels"], s["params"]
    mesh = make_mesh(shape, ("group", "member"), device="cpu", virtual=True)
    args = (g.node_feat, *dist_inputs(g, shape[0] * shape[1]), labels)
    # the gradient is the single-device step's (the global mean NLL's)
    step = gnn_dist.make_sage_dist_step(cfg, Capture(), mesh, g.n_nodes,
                                        hierarchical=hierarchical)
    _, grads, loss = step(params, None, *args)
    _, want, want_loss = TS.make_gnn_train_step("sage", cfg, Capture())(params, None, g, labels)
    assert abs(float(loss) - float(want_loss)) < 1e-4
    for k, gr in grads.items():
        scale = float(want[k].abs().max())
        assert float((gr - want[k]).abs().max()) <= 1e-5 * scale, k
    # one AdamW step against JAX's single-device step and the port's
    opt = AdamW(constant(1e-3))
    step = gnn_dist.make_sage_dist_step(cfg, opt, mesh, g.n_nodes,
                                        hierarchical=hierarchical)
    new, state, loss = step(params, opt.init(params), *args)
    single, _, _ = TS.make_gnn_train_step("sage", cfg, opt)(params, opt.init(params),
                                                            g, labels)
    assert abs(float(loss) - s["jloss"]) < 1e-4
    assert int(state.step) == 1
    for k, p in new.items():
        assert float(np.abs(p.numpy() - s["jnew"][k]).max()) < 1e-5, k
        assert float((p - single[k]).abs().max()) < 1e-5, k


def test_dist_step_refuses_uneven_shards():
    s = setup()
    mesh = make_mesh((2, 2), ("group", "member"), device="cpu", virtual=True)
    with pytest.raises(ValueError, match="split"):
        gnn_dist.make_sage_dist_step(s["cfg"], Capture(), mesh, s["g"].n_nodes + 2)


BF16_SCRIPT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get
from repro.models.gnn_dist import make_sage_dist_step
from repro.optim import AdamW, constant
from repro.util import make_mesh

z = dict(np.load(sys.argv[1]))
cfg = get("graphsage-reddit").make_smoke_config()
params = {"layers": [{"w_self": jnp.asarray(z[f"w_self{i}"]),
                      "w_neigh": jnp.asarray(z[f"w_neigh{i}"])} for i in range(2)]}
mesh = make_mesh((2, 4), ("data", "model"))
opt = AdamW(constant(1e-3))
step = make_sage_dist_step(cfg, opt, mesh, ("data", "model"), z["feats"].shape[0],
                           gather_dtype=jnp.bfloat16)
args = (params, opt.init(params), jnp.asarray(z["feats"]), jnp.asarray(z["src"]),
        jnp.asarray(z["dst"]), jnp.asarray(z["valid"]), jnp.asarray(z["labels"]))
compiled = jax.jit(step).lower(*args).compile({"xla_allow_excess_precision": False})
new, _, loss = compiled(*args)
out = {"loss": np.asarray(loss)}
for i in range(2):
    for k in ("w_self", "w_neigh"):
        out[f"{k}{i}"] = np.asarray(new["layers"][i][k])
np.savez(sys.argv[2], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    s = setup()
    feats, src, dst, valid, labels = s["arrays"]
    ps, pd, pv = partition_like_jax(src, dst, valid, s["g"].n_nodes, 8)
    d = tmp_path_factory.mktemp("jax_bf16")
    jp = s["jp"]["layers"]
    np.savez(d / "in.npz", feats=feats, src=ps, dst=pd, valid=pv, labels=labels,
             **{f"{k}{i}": jp[i][k] for i in range(2) for k in ("w_self", "w_neigh")})
    proc = respawn_with_host_devices(
        [sys.executable, "-c", textwrap.dedent(BF16_SCRIPT), str(d / "in.npz"),
         str(d / "out.npz")], 8, extra_env={"JAX_PLATFORMS": "cpu"},
        pythonpath=(REPO_SRC,), capture=True, timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def test_bf16_gather_step_matches_jax_dist_step(jax_bf16):
    s = setup()
    cfg, g, labels, params = s["cfg"], s["g"], s["labels"], s["params"]
    mesh = make_mesh((2, 4), ("group", "member"), device="cpu", virtual=True)
    opt = AdamW(constant(1e-3))
    step = gnn_dist.make_sage_dist_step(cfg, opt, mesh, g.n_nodes,
                                        gather_dtype=torch.bfloat16)
    new, _, loss = step(params, opt.init(params), g.node_feat,
                        *dist_inputs(g, 8), labels)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jax_bf16["loss"])) < BF16_LOSS_TOL
    assert 0 < abs(float(loss) - s["jloss"]) < BF16_VS_F32_REL * s["jloss"]
    for i in range(2):
        for k in ("w_self", "w_neigh"):
            got = new[f"layers/{i}/{k}"]
            assert got.dtype == torch.float32
            err = float(np.abs(got.numpy() - jax_bf16[f"{k}{i}"]).max())
            assert err < BF16_PARAM_TOL, (k, i, err)
