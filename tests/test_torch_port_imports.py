"""The port stands alone: no module of it, nor ``chip_smoke.py``, imports
JAX or anything of the JAX package (it runs where JAX is not installed)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "dist_gnn_tpu")
FILES = sorted((ROOT / "dist_gnn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), filename=str(path))))
    assert not roots & set(FORBIDDEN), f"{path.name} imports {sorted(roots & set(FORBIDDEN))}"


def test_walk_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    for module in ("ops/gather.py", "ops/gat.py", "models/gat.py", "training/trainer.py"):
        assert f"dist_gnn_tpu_torch/{module}" in names
    assert len(names) >= 17
