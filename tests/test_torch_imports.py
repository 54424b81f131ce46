"""Import hygiene of the port: no file of artgraph_tpu_torch/, tools/ or
chip_smoke.py imports the JAX package or JAX, at any nesting (a lazy import
inside a function counts). Parsed with `ast`, so nothing is imported here.
"""
import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("artgraph_tpu", "jax", "jaxlib", "flax", "optax")
FILES = sorted((REPO / "artgraph_tpu_torch").rglob("*.py")) + \
    sorted((REPO / "tools").glob("*.py")) + [REPO / "chip_smoke.py"]


def forbidden_imports(source: str) -> list[str]:
    """Module names imported by `source` that name the JAX package or JAX."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return found


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax(path):
    assert forbidden_imports(path.read_text()) == []


def test_checker_sees_nested_and_lazy_imports():
    src = ("import numpy\n"
           "def f():\n"
           "    if True:\n"
           "        from artgraph_tpu import config\n"
           "    import jax.numpy as jnp\n"
           "from artgraph_tpu_torch import config\n")
    assert sorted(forbidden_imports(src)) == ["artgraph_tpu", "jax.numpy"]
