"""Import hygiene of the port: no file of artgraph_tpu_torch/, tools/,
chip_smoke.py or __graft_entry_torch__.py, and no code cell of the port's
notebook, imports the JAX package or JAX, at any nesting (a lazy import
inside a function counts). And the modules of ops/ import downward only:
the launch table no op module, the block GEMM / LayerNorm layer neither
block op, the MLP block nothing of the attention block. Parsed with `ast`,
so nothing is imported here.
"""
import ast
import json
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("artgraph_tpu", "jax", "jaxlib", "flax", "optax")
FILES = sorted((REPO / "artgraph_tpu_torch").rglob("*.py")) + \
    sorted((REPO / "tools").glob("*.py")) + [REPO / "chip_smoke.py",
                                             REPO / "__graft_entry_torch__.py"]
NOTEBOOK = REPO / "notebooks" / "proposed_model_multitask_torch.ipynb"


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


def test_port_notebook_imports_no_jax():
    cells = [c for c in json.loads(NOTEBOOK.read_text())["cells"]
             if c["cell_type"] == "code"]
    assert cells
    for cell in cells:
        assert forbidden_imports("".join(cell["source"])) == []


OPS = REPO / "artgraph_tpu_torch" / "ops"


def imported_modules(source: str) -> set[str]:
    """Every module `source` imports, at any nesting; `from pkg import name`
    counts as both pkg and pkg.name, since name may be a module."""
    found = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found |= {alias.name for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module)
            found |= {f"{node.module}.{alias.name}" for alias in node.names}
    return found


# (module of ops/, the modules of ops/ it must not import): the launch
# table sits under every op, the block GEMM / LayerNorm layer under both
# block ops, and the MLP block beside the attention block
LAYERS = [("launches", sorted(p.stem for p in OPS.glob("*.py")
                              if p.stem not in ("__init__", "launches"))),
          ("block_gemm", ["attention", "mlp"]),
          ("mlp", ["attention"])]


@pytest.mark.parametrize("module,below", LAYERS, ids=[m for m, _ in LAYERS])
def test_ops_import_downward_only(module, below):
    imported = imported_modules((OPS / f"{module}.py").read_text())
    assert not imported & {f"artgraph_tpu_torch.ops.{m}" for m in below}


def test_checker_sees_nested_and_lazy_imports():
    src = ("import numpy\n"
           "def f():\n"
           "    if True:\n"
           "        from artgraph_tpu import config\n"
           "    import jax.numpy as jnp\n"
           "from artgraph_tpu_torch import config\n")
    assert sorted(forbidden_imports(src)) == ["artgraph_tpu", "jax.numpy"]
    assert {"artgraph_tpu.config", "artgraph_tpu_torch.config"} <= \
        imported_modules(src)
