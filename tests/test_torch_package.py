"""Package boundaries of the PyTorch port: it imports neither ``jax`` nor
anything of ``repro``, its entry points run on the card unless asked for
the CPU, and ``chip_smoke.py`` refuses to run without a card or without
the repository beside it."""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def test_import_leaves_jax_and_repro_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.core.pipeline\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "import repro_torch.models.recsys, repro_torch.train.train_step\n"
        "import repro_torch.configs, repro_torch.data.synthetic\n"
        "import repro_torch.data.graphs, repro_torch.core.sssp_steps\n"
        "import repro_torch.core.faults, repro_torch.serve.engine\n"
        "import repro_torch.data.query_trace, repro_torch.core.tune\n"
        "import repro_torch.comms.topology, repro_torch.comms.mesh\n"
        "import repro_torch.comms.hierarchical, repro_torch.core.distributed_bfs\n"
        "import repro_torch.launch.multiprocess, repro_torch.launch.train\n"
        "import repro_torch.optim, repro_torch.train.checkpoint\n"
        "import repro_torch.train.loop, repro_torch.train.elastic\n"
        "import repro_torch.models.layers, repro_torch.models.transformer\n"
        "import repro_torch.models.moe, repro_torch.configs.lm_archs\n"
        "import repro_torch.models.gnn, repro_torch.models.gnn_dist\n"
        "import repro_torch.data.sampler, repro_torch.configs.gnn_archs\n"
        "import repro_torch.launch.mesh, repro_torch.launch.collective_census\n"
        "import repro_torch.launch.input_specs, repro_torch.launch.dryrun\n"
        "import repro_torch.data, repro_torch.models\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("sub", ["data", "models"])
def test_subpackages_bind_their_modules(sub):
    """``repro_torch.data`` and ``repro_torch.models`` bind the submodules
    that ``repro``'s do, with the same ``__all__`` (read from the JAX
    package's source, not imported)."""
    import importlib

    tree = ast.parse((REPO / "src" / "repro" / sub / "__init__.py").read_text())
    want = next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__" for t in node.targets))
    pkg = importlib.import_module(f"repro_torch.{sub}")
    assert pkg.__all__ == want
    for name in want:
        assert getattr(pkg, name).__name__ == f"repro_torch.{sub}.{name}"


def test_no_jax_or_repro_imports_in_source():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 25
    for path in files + [REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_kernel_sources_exist_with_headers():
    # the header note: which TPU kernel, what bounds it, what the design does
    for name, tpu in (("frontier_update", "bitmap_ops.py"),
                      ("core_spmv", "frontier_spmv.py"),
                      ("spmv_mxu", "spmv_mxu.py"), ("cin_layer", "cin.py")):
        text = (PKG / "kernels" / "csrc" / f"{name}.cu").read_text()
        head = text[:4000]
        assert "Replaces:" in head and f"src/repro/kernels/{tpu}" in head
        assert "What bounds it" in head and "What the design does" in head
        assert 'extern "C" int' in text and "cudaGetLastError" in text


def test_sssp_relax_source_says_it_replaces_no_tpu_kernel():
    text = (PKG / "kernels" / "csrc" / "sssp_relax.cu").read_text()
    head = text[:4000]
    assert "Replaces: no TPU kernel" in head and "src/repro/core/" in head
    assert "What bounds it" in head and "What the design does" in head
    assert 'extern "C" int' in text and "cudaGetLastError" in text


def test_every_kernel_source_has_a_counted_wrapper():
    from repro_torch.kernels import ops
    sources = sorted(p.stem for p in (PKG / "kernels" / "csrc").glob("*.cu"))
    assert sorted(k.lib_name for k in ops.KERNELS.values()) == sources
    assert sorted(ops.KERNELS) == sources


def test_entry_points_need_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch import convert
    from repro_torch.core import kronecker, pipeline
    from repro_torch.core.plan import BFSPlan, compile_plan
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.build(pipeline.Graph500Config(scale=6))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kronecker.generate_edges(0, 6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.edge_list_from_numpy(np.zeros(4, np.int32), np.ones(4, np.int32), 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.build(pipeline.Graph500Config(scale=6, device="cuda"))
    cfg = pipeline.Graph500Config(scale=6, edge_factor=4, n_roots=2, device="cpu")
    built = pipeline.build(cfg)
    assert built.ev.src.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_plan(BFSPlan(), built)
    from repro_torch.serve.engine import Engine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(built)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.serve(dataclasses.replace(cfg, device=None), built=built)
    _, run = pipeline.run(cfg, built)
    assert run.all_valid and len(run.teps) == 2
    # the LM stack: parameters, batches, caches and the launcher's LM branch
    from repro_torch.configs import get
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer
    lm = get("olmo-1b").make_smoke_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(lm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_cache(lm, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_batch(0, 0, 1, 8, lm.vocab)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "olmo-1b", "--steps", "1"], log=lambda m: None)
    assert transformer.init_params(lm, device="cpu")["embed"].device.type == "cpu"
    # the GNN stack: parameters, graphs, the sampler and the launcher's branch
    from repro_torch.data import graphs
    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.models import gnn
    sage = get("graphsage-reddit").make_smoke_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gnn.sage_init(sage)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graphs.make_feature_graph(0, 6, d_feat=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graphs.make_molecule_batch(0, 2, 4, 6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NeighborSampler(np.array([0, 1]), np.array([0]), (2,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "gat-cora", "--steps", "1"], log=lambda m: None)
    assert gnn.sage_init(sage, device="cpu")["layers/0/w_self"].device.type == "cpu"


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
