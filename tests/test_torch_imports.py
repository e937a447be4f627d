"""The port stands alone: no module of ``tpusim_torch/`` and not
``chip_smoke.py`` imports JAX or the JAX package ``tpusim``."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "tpusim_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "tpusim")


def _imports(tree: ast.AST) -> list[str]:
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def test_scan_sees_the_package():
    rel = {p.relative_to(REPO).as_posix() for p in FILES}
    assert "tpusim_torch/__main__.py" in rel
    assert "tpusim_torch/kernels/flash_attention.py" in rel
    assert "chip_smoke.py" in rel


def test_scan_catches_forbidden_imports():
    tree = ast.parse("import jax.numpy as jnp\nfrom tpusim.ir import X\n"
                     "import tpusim_torch.ir\n")
    assert [n for n in _imports(tree) if _forbidden(n)] == [
        "jax.numpy", "tpusim.ir"]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_tpusim_import(path):
    bad = [n for n in _imports(ast.parse(path.read_text())) if _forbidden(n)]
    assert bad == [], f"{path.name} imports {bad}"
