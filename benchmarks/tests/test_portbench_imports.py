"""No file of the benchmark imports JAX or the JAX package, and the plain
reference, with the plain trunks of portbench/trunks/, imports nothing of
the port (whole top-level names compared)."""
import ast
import subprocess
import sys

from tiny import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "artgraph_tpu"}


def imported_tops(source):
    """The top-level names that a file (a path) or a parsed tree imports."""
    tree = source if isinstance(source, ast.AST) else ast.parse(
        source.read_text())
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


PLAIN = {"__future__", "contextlib", "functools", "math", "numpy", "torch",
         "PIL", "portbench"}
# the trunk modules' functions that reach the port, and only when called
PORT_SIDE = {"fusion_class", "patch_tiny"}


def test_the_reference_imports_nothing_of_the_port():
    tops = imported_tops(BENCH / "portbench" / "reference.py")
    assert tops <= PLAIN, tops
    trunk_files = sorted((BENCH / "portbench" / "trunks").glob("*.py"))
    assert len(trunk_files) >= 3
    for path in trunk_files:
        tree = ast.parse(path.read_text())
        outside = [n for n in tree.body if not (
            isinstance(n, ast.FunctionDef) and n.name in PORT_SIDE)]
        tops = imported_tops(ast.Module(body=outside, type_ignores=[]))
        assert tops <= PLAIN | {"importlib", "types"}, (path, tops)


def test_the_plain_models_load_nothing_of_the_port():
    """Every configuration's plain model built and run in a fresh process,
    which then holds no module of the port."""
    code = """if True:
        import json, sys
        sys.path[:0] = [sys.argv[1], sys.argv[2]]
        import torch
        from portbench import flops, inputs, reference
        manifest = json.load(open(sys.argv[2] + "/BENCHMARK.json"))
        for c in manifest["configs"]:
            cfg = json.load(open(sys.argv[2] + "/" + c["file"]))
            with torch.device("meta"):
                model = reference.PlainFusion(cfg)
                x = torch.zeros(1, cfg["img_size"], cfg["img_size"], 3,
                                dtype=torch.uint8)
                e = torch.zeros(1, cfg["emb_size"])
                model(x, e, e, reference.Precision(), train=False)
            flops.forward_flops(cfg)
            inputs.make_weights([("w", (2, 2))], 1, "cpu", cfg)
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] == "artgraph_tpu_torch"))
    """
    out = subprocess.run([sys.executable, "-c", code, str(BENCH),
                          str(BENCH.parent)], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]", out
