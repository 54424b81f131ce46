"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port (whole top-level names compared)."""
import ast

from tiny import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "artgraph_tpu"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(node.args[0].value.split(".")[0])
    return tops


def test_no_jax_anywhere_in_the_benchmark():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not imported_tops(path) & FORBIDDEN, path


def test_the_top_level_names_are_compared_whole():
    assert "artgraph_tpu_torch" not in FORBIDDEN
    assert "artgraph_tpu_torch".split(".")[0] != "artgraph_tpu"


def test_the_reference_imports_nothing_of_the_port():
    tops = imported_tops(BENCH / "portbench" / "reference.py")
    assert tops <= {"__future__", "contextlib", "math", "numpy", "torch",
                    "PIL"}, tops
