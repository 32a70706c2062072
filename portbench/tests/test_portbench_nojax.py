"""No run loads JAX or the JAX package (checked on whole top-level names),
the reference imports nothing of the program, and without a card, or in a
checkout without the program, no result is printed."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import cell  # noqa: E402

BENCH = ROOT / "portbench"


@pytest.mark.parametrize("name,flagged", [
    ("repro", True), ("repro.core.plan", True), ("jax", True), ("jax.numpy", True),
    ("jaxlib.xla_client", True), ("flax.linen", True), ("repro_torch", False),
    ("repro_torch.core", False), ("jaxtyping", False), ("reprox", False),
])
def test_forbidden_names_are_whole_top_level_names(monkeypatch, name, flagged):
    for m in list(sys.modules):
        if m.split(".")[0] in cell.FORBIDDEN:
            monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, object())
    assert bool(cell.forbidden_loaded()) is flagged


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & set(cell.FORBIDDEN)
    if ({"reference", "weights"} & set(path.parts)
            or path.name in ("compare.py", "control.py", "inputs.py", "teps.py", "roofline.py")):
        assert "repro_torch" not in _imports(path)


def test_the_program_is_taken_from_the_checkout_only(tmp_path):
    with pytest.raises(ImportError):
        cell.load_program(tmp_path)


def test_no_card_no_result(tmp_path):
    # a directory holding only BENCHMARK.json and the benchmark folder
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "bfs-spec-s22",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
