"""The port's shape-only dry run (``repro_torch.launch``) against the JAX
package's (``repro.launch``).

The JAX references come from one subprocess with 8 forced host devices: the
cell plans of every registry cell on a ``(2, 4)`` ``("data", "model")`` and
a ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh (and one case of each
variant), the ``tuned`` graph500 variant against a temporary table,
``collective_stats`` on synthetic HLO lines, and the census of the compiled
``bfs_s22`` cell.  The port builds the same cells on virtual ``meta``
meshes: every input leaf's shape, dtype and shard shape, the analytic
MODEL_FLOPS, the skip reasons, the supplementary flags and the notes must
equal JAX's exactly; the census formulas too.
"""
import json
import os
import sys
import textwrap

import pytest
import torch

from repro.util import respawn_with_host_devices

from repro_torch.comms import hierarchical as H
from repro_torch.comms import mesh as comms_mesh
from repro_torch.configs import all_cells
from repro_torch.configs import get
from repro_torch.launch import collective_census as CC
from repro_torch.launch import dryrun, input_specs, mesh as mesh_lib

torch.set_num_threads(2)

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}

# one case of each variant: (mesh, arch, shape, variant)
VARIANTS = [
    ("2x4", "granite-moe-1b-a400m", "train_4k", "local_tp"),
    ("2x4", "granite-moe-1b-a400m", "train_4k", "local_tp_sp"),
    ("2x2x2", "granite-moe-1b-a400m", "train_4k", "monitor_a2a"),
    ("2x4", "olmo-1b", "train_4k", "seq_sharded"),
    ("2x2x2", "olmo-1b", "train_4k", "seq_sharded_zero1"),
    ("2x4", "olmo-1b", "prefill_32k", "qchunk"),
    ("2x2x2", "minicpm-2b", "train_4k", "qchunk_sp"),
    ("2x2x2", "starcoder2-15b", "train_4k", "zero1"),
    ("2x4", "graphsage-reddit", "ogb_products", "owner_gather"),
    ("2x2x2", "graphsage-reddit", "ogb_products", "owner_gather_flat"),
    ("2x4", "graphsage-reddit", "ogb_products", "owner_gather_bf16"),
    ("2x4", "graph500", "bfs_s22", "flat"),
    ("2x2x2", "graph500", "bfs_s26", "gather"),
]
BASELINE = [(m, a, s, "baseline") for m in MESHES for a, s in all_cells()]

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")
GROUPS = (1, 2, 4, 8)
DTYPES = (("bf16", (8, 128)), ("f32", (16, 24)), ("s32", (4096,)), ("pred", (3, 5)))
EXCHANGES = ("baseline", "gather", "flat")

JAX_SCRIPT = r"""
import json, sys
import jax
from jax.sharding import NamedSharding
from repro.util import make_mesh
from repro.launch.input_specs import build_cell
from repro.launch.hlo_analysis import collective_stats

cases, table = json.loads(sys.argv[2]), sys.argv[3]
meshes = {name: make_mesh(tuple(shape), tuple(axes))
          for name, (shape, axes) in json.loads(sys.argv[4]).items()}


def key(path):
    return "/".join(str(next(getattr(q, a) for a in ("key", "idx", "name")
                             if hasattr(q, a))) for q in path)


def plan_of(plan):
    leaves = jax.tree_util.tree_flatten_with_path(plan.args)[0]
    shs = jax.tree_util.tree_flatten_with_path(
        plan.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    assert [key(p) for p, _ in leaves] == [key(p) for p, _ in shs]
    return {"args": {key(p): [list(s.shape), str(s.dtype), list(ns.shard_shape(s.shape))]
                     for (p, s), (_, ns) in zip(leaves, shs)},
            "flops": plan.model_flops_global, "skip": plan.skip_reason,
            "supp": plan.supplementary, "note": plan.note}


out = {"cells": {}}
for m, a, s, v in cases:
    out["cells"]["|".join((m, a, s, v))] = plan_of(build_cell(a, s, meshes[m], v))
import os
os.environ["REPRO_TUNED_PLANS"] = table
out["tuned_note"] = build_cell("graph500", "bfs_s22", meshes["2x4"], "tuned").note

hlo = {}
groups = {1: "{{0}}", 2: "{{0,1},{2,3}}", 4: "{{0,1,2,3},{4,5,6,7}}",
          8: "{{0,1,2,3,4,5,6,7}}"}
for kind in %(kinds)r:
    for n in %(groups)r:
        for dt, shape in %(dtypes)r:
            dims = ",".join(map(str, shape))
            line = (f"  %%x = {dt}[{dims}]{{0}} {kind}({dt}[{dims}]{{0}} %%p), "
                    f"channel_id=1, replica_groups={groups[n]}, dimensions={{0}}")
            hlo[f"{kind}|{n}|{dt}"] = collective_stats(line, 8).to_json()
out["hlo"] = hlo

census = {}
for v in %(exchanges)r:
    plan = build_cell("graph500", "bfs_s22", meshes["2x4"], v)
    c = jax.jit(plan.step, in_shardings=plan.in_shardings,
                out_shardings=plan.out_shardings).lower(*plan.args).compile()
    census[v] = collective_stats(c.as_text(), 8).to_json()
out["census"] = census
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("OK")
""" % {"kinds": KINDS, "groups": GROUPS, "dtypes": DTYPES, "exchanges": EXCHANGES}


def write_table(path) -> None:
    """A tuned-plan table both packages read: one ``hier_gather`` winner at
    scale 12 on a (2, 4) mesh."""
    plan = {"alpha": 14.0, "batch_roots": True, "beta": 24.0, "engine": "bitmap",
            "exchange": "hier_gather", "kernel": "bfs", "layout": ["group", "member"],
            "max_levels": 64, "mesh_shape": [2, 4], "n_chunks": 64,
            "partition": "block"}
    entry = {"scale": 12, "n_devices": 8, "backend": "cpu", "interpret_mode": True,
             "budget": "small", "seed": 0, "n_roots": 2, "reps": 1,
             "created_unix": 0, "plan": plan, "per_root_us": 1.0,
             "harmonic_mean_teps": 1.0, "identical": True, "ranked": [],
             "n_skipped": 0}
    with open(path, "w") as f:
        json.dump({"schema_version": 2, "entries": {"scale12/dev8/cpu": entry}}, f)


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    path = tmp_path_factory.mktemp("tuned") / "TUNED_PLANS.json"
    write_table(path)
    return str(path)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory, table):
    path = tmp_path_factory.mktemp("jax_dryrun") / "out.json"
    cases = BASELINE + VARIANTS
    proc = respawn_with_host_devices(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), str(path),
         json.dumps(cases), table, json.dumps(MESHES)], 8,
        extra_env={"JAX_PLATFORMS": "cpu"}, pythonpath=(REPO_SRC,), capture=True,
        timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def meta_mesh(name):
    shape, axes = MESHES[name]
    return mesh_lib.make_host_mesh(shape, axes, device="meta")


# ---------------------------------------------------------------------------
# The cell plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", BASELINE + VARIANTS, ids="|".join)
def test_cell_plan_equal_to_jax(jax_ref, case):
    m, arch, shape, variant = case
    mesh = meta_mesh(m)
    plan = input_specs.build_cell(arch, shape, mesh, variant)
    want = jax_ref["cells"]["|".join(case)]
    got = {path: [list(s), dt, list(sh)] for path, (s, dt, sh)
           in input_specs.leaf_layout(plan.args, plan.in_shardings, mesh).items()}
    assert got == want["args"]
    assert plan.model_flops_global == want["flops"]
    assert plan.skip_reason == want["skip"]
    assert plan.supplementary == want["supp"]
    assert plan.note == want["note"]
    assert all(t.device.type == "meta" for _, t in input_specs.flatten(plan.args))


def test_tuned_variant_equal_to_jax(jax_ref, table, monkeypatch):
    """``variant="tuned"`` reads the port's table (its own variable) and
    names the same exchange and source as JAX's cell on the same table."""
    monkeypatch.setenv("REPRO_TORCH_TUNED_PLANS", table)
    plan = input_specs.build_cell("graph500", "bfs_s22", meta_mesh("2x4"), "tuned")
    assert plan.note == jax_ref["tuned_note"]
    assert "exchange=hier_gather" in plan.note
    assert "exchange_source=tuned:nearest_scale12" in plan.note


def test_shard_shape_refuses_a_dimension_the_axes_do_not_divide():
    mesh = meta_mesh("2x4")
    assert input_specs.shard_shape((8, 6), input_specs.Spec((("data", "model"),)),
                                   mesh) == (1, 6)
    with pytest.raises(ValueError):
        input_specs.shard_shape((6,), input_specs.Spec(("model",)), mesh)


# ---------------------------------------------------------------------------
# The census
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_census_formulas_equal_to_jax(jax_ref, kind):
    for n in GROUPS:
        for dt, shape in DTYPES:
            got = CC.collective_stats([(kind, CC.shape_bytes(dt, shape), n)]).to_json()
            assert got == jax_ref["hlo"][f"{kind}|{n}|{dt}"], (kind, n, dt)


@pytest.mark.parametrize("variant", EXCHANGES)
def test_graph500_level_census_against_jax(jax_ref, variant):
    """The level body's census against JAX's compiled ``bfs_s22`` cell: the
    same collective kinds and the exchange's link bytes equal.  The one
    difference: the level's scalar sums are one all-reduce of the engine's
    four int64 sums (32 bytes) in the port, one of two int32 scalars
    (8 bytes, the psums XLA combined and kept) in JAX."""
    rec = dryrun.run_cell("graph500", "bfs_s22", False, variant, mesh=meta_mesh("2x4"))
    got, want = rec["collectives"], jax_ref["census"][variant]
    assert set(got["counts"]) == set(want["counts"])
    assert got["modeled"]["counts"] == {}
    for kind in want["counts"]:
        if kind == "all-reduce":
            continue
        assert got["counts"][kind] == want["counts"][kind], kind
        assert got["link_bytes"][kind] == want["link_bytes"][kind], kind
        assert got["operand_bytes"][kind] == want["operand_bytes"][kind], kind
    assert got["counts"]["all-reduce"] == want["counts"]["all-reduce"] == 1
    assert want["operand_bytes"]["all-reduce"] == 2 * 4
    assert got["operand_bytes"]["all-reduce"] == 4 * 8


def test_census_records_the_hier_or_legs_and_nothing_when_inactive():
    mesh = comms_mesh.make_mesh((2, 4), ("group", "member"), device="cpu", virtual=True)
    comm = comms_mesh.VertexComm(mesh)
    xs = [torch.full((16,), 1 << d, dtype=torch.int32) for d in range(8)]
    assert comms_mesh._census is None
    with CC.Census() as census:
        out = H.hierarchical_por(comm, xs)
    assert comms_mesh._census is None
    assert torch.equal(out[0], torch.full((16,), 255, dtype=torch.int32))
    assert [e[:3] for e in census.entries] == [
        ("all-to-all", 64, 4), ("all-gather", 32, 2), ("all-gather", 64, 4)]
    H.hierarchical_por(comm, xs)
    assert len(census.entries) == 3


def test_census_models_the_transpose_of_a_differentiated_gather():
    mesh = comms_mesh.make_mesh((1, 2), ("group", "member"), device="cpu", virtual=True)
    comm = comms_mesh.VertexComm(mesh)
    xs = [torch.ones(3, 2, requires_grad=True) for _ in range(2)]
    with CC.Census() as census:
        H.hierarchical_all_gather(comm, xs)
    assert [e[:4] for e in census.entries] == [("all-gather", 48, 2, False),
                                                ("reduce-scatter", 48, 2, True)]


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_counter_products_are_2mnk(dtype):
    a, b = torch.randn(6, 5, dtype=dtype), torch.randn(5, 7, dtype=dtype)
    x = torch.randn(3, 6, 5, dtype=dtype)
    v = torch.randn(5, dtype=dtype)
    name = str(dtype).removeprefix("torch.")
    for fn, flops in ((lambda: a @ b, 2 * 6 * 5 * 7),
                      (lambda: x @ b, 2 * 3 * 6 * 5 * 7),
                      (lambda: torch.einsum("bij,jk->bik", x, b), 2 * 3 * 6 * 5 * 7),
                      (lambda: a @ v, 2 * 6 * 5)):
        _, cnt = dryrun.count_step(fn, ())
        assert dict(cnt.flops) == {name: flops}


def lm_smoke_step(device):
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizer import AdamW, cosine
    from repro_torch.train import train_step as TS

    cfg = get("olmo-1b").make_smoke_config()
    opt = AdamW(cosine(3e-4, 10, 100))
    params = (T.param_template(cfg) if device == "meta"
              else T.init_params(cfg, seed=0, device=device))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen, dtype=torch.int32)
    batch = {"tokens": tokens.to(device), "labels": tokens.roll(-1, 1).to(device)}
    step = TS.make_lm_train_step(cfg, opt, T.ShardingPolicy(remat=True))
    return step, (params, opt.init(params), batch)


def test_counter_flops_equal_on_meta_and_cpu():
    counts = {}
    for device in ("meta", "cpu"):
        step, args = lm_smoke_step(device)
        _, cnt = dryrun.count_step(step, args)
        counts[device] = (dict(cnt.flops), cnt.bytes, cnt.peak)
    assert counts["meta"] == counts["cpu"]
    assert counts["meta"][0]["bfloat16"] > 0 and counts["meta"][0]["float32"] > 0


def test_lm_train_step_counts_at_least_6_n_tokens():
    """The full olmo-1b step (remat on) at B = 1, S = 256 on meta: at least
    6 x the active parameters x the tokens, as the analytic count says."""
    from repro_torch.configs.lm_archs import padded_vocab
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizer import AdamW, cosine
    from repro_torch.train import train_step as TS

    cfg = padded_vocab(get("olmo-1b").make_config())
    params = T.param_template(cfg)
    opt = AdamW(cosine(3e-4, 10, 100))
    batch = {k: torch.empty((1, 256), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    step = TS.make_lm_train_step(cfg, opt, T.ShardingPolicy(remat=True))
    _, cnt = dryrun.count_step(step, (params, opt.init(params), batch))
    assert sum(cnt.flops.values()) >= 6 * cfg.active_param_count() * 256


def test_meta_tensors_take_the_plain_kernel_versions():
    from repro_torch.kernels import ops

    found = torch.empty(64, dtype=torch.int32, device="meta")
    nxt, vis, count = ops.frontier_update(found, found)
    assert nxt.device.type == vis.device.type == "meta" and tuple(nxt.shape) == (64,)
    x0 = torch.empty(4, 3, 2, device="meta")
    out = ops.cin_layer(x0, x0, torch.empty(5, 3, 3, device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (4, 5, 2)


# ---------------------------------------------------------------------------
# The record, the roofline table and the CLI
# ---------------------------------------------------------------------------

def test_production_mesh_and_constants():
    from repro_torch.util import resolve_device

    assert resolve_device("meta").type == "meta"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data", "model"))):
        m = mesh_lib.make_production_mesh(multi_pod=multi)
        assert (m.shape, m.axis_names) == (shape, axes)
        assert m.devices[0].type == "meta" and len(m.devices) == (
            mesh_lib.CHIPS_MULTI_POD if multi else mesh_lib.CHIPS_SINGLE_POD)
    g = mesh_lib.make_group_mesh(device="cpu")
    assert (g.shape, g.axis_names) == ((1, 1), ("group", "member"))
    assert mesh_lib.make_group_mesh((2, 4), device="meta", virtual=True).shape == (2, 4)
    assert mesh_lib.CARD == "NVIDIA H100 80GB HBM3 (SXM5), 700 W"
    assert (mesh_lib.PEAK_FLOPS_BF16, mesh_lib.PEAK_FLOPS_FP32, mesh_lib.HBM_BW,
            mesh_lib.LINK_BW) == (989.4e12, 66.9e12, 3.35e12, 50e9)


def test_roofline_table_renders_port_records(tmp_path, monkeypatch):
    import benchmarks.roofline as roofline

    cells = [("xdeepfm", "serve_p99"), ("graphsage-reddit", "full_graph_sm"),
             ("olmo-1b", "long_500k")]
    d = tmp_path / "singlepod"
    d.mkdir()
    for arch, shape in cells:
        rec = dryrun.run_cell(arch, shape, False)
        assert rec["ok"] and rec["mesh"] == "16x16" and rec["chips"] == 256
        assert rec["roofline"]["compute_s"] > 0 and rec["roofline"]["memory_s"] > 0
        (d / f"{arch}__{shape}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(roofline, "DRYRUN_DIR", str(tmp_path))
    table = roofline.markdown_table("singlepod")
    rows = table.splitlines()[2:]
    assert len(rows) == 3
    assert any(r.startswith("| olmo-1b | long_500k |") and "SKIP(full-attn)" in r
               for r in rows)


def test_cli_writes_one_record(tmp_path, monkeypatch):
    monkeypatch.setenv("DRYRUN_OUT", str(tmp_path))
    assert dryrun.main(["--arch", "gat-cora", "--shape", "molecule", "--multi-pod",
                        "--quiet"]) == 0
    rec = json.loads((tmp_path / "multipod" / "gat-cora__molecule.json").read_text())
    assert rec["ok"] and rec["mesh"] == "2x16x16" and rec["chips"] == 512
    assert rec["card"] == "NVIDIA H100 80GB HBM3 (SXM5), 700 W"
    assert rec["constants"]["link_bw"] == 50e9
    assert rec["collectives"]["extrapolated"] is False
    assert rec["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes"}
    assert rec["hbm_per_device_bytes"] == pytest.approx(
        rec["memory"]["argument_bytes"] + rec["memory"]["output_bytes"]
        + rec["memory"]["temp_bytes"] - rec["memory"]["alias_bytes"])


def test_owner_gather_step_with_padding_equals_the_dropping_step():
    """``keep_padding=True`` (the dry run's shape-only form, JAX's padded
    blocks) gives the step that drops each shard's padding, bit for bit on
    the CPU: the padding slots feed only the dropped segment."""
    from repro_torch.data.graphs import make_feature_graph
    from repro_torch.models import gnn, gnn_dist

    cfg = get("graphsage-reddit").make_smoke_config()
    g, labels = make_feature_graph(0, 9, d_feat=cfg.d_in, n_classes=cfg.n_classes,
                                   edge_factor=4, device="cpu")
    params = gnn.sage_init(cfg, seed=0, device="cpu")
    mesh = comms_mesh.make_mesh((2, 2), ("group", "member"), device="cpu", virtual=True)
    args = (g.node_feat, *gnn_dist.partition_edges(g.edge_src, g.edge_dst, g.edge_valid,
                                                   g.n_nodes, 4), labels)

    class Capture:
        def init(self, params):
            return None

        def update(self, grads, state, params):
            return params, grads

    out = [gnn_dist.make_sage_dist_step(cfg, Capture(), mesh, g.n_nodes,
                                        keep_padding=keep)(params, None, *args)
           for keep in (False, True)]
    assert torch.equal(out[0][2], out[1][2])
    assert all(torch.equal(out[0][1][k], out[1][1][k]) for k in params)
