"""desco_tpu_torch stands alone: no file of it (nor chip_smoke.py) imports
jax, flax, optax or desco_tpu, and networkx only inside a function (the
test-only ``Graph.to_networkx``). Checked on the source: this process
has jax preloaded, so sys.modules cannot tell."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "desco_tpu"}
SOURCES = sorted((ROOT / "desco_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(tree):
    """(module root, node, inside a function) for every absolute import."""
    def walk(node, in_fn):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name.split(".")[0], child, fn
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module.split(".")[0], child, fn
            yield from walk(child, fn)

    yield from walk(tree, False)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_desco_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for root, node, in_fn in _imports(tree):
        assert root not in FORBIDDEN, (
            f"{path.relative_to(ROOT)}:{node.lineno} imports {root}")
        if root == "networkx":
            assert in_fn, (f"{path.relative_to(ROOT)}:{node.lineno} imports "
                           f"networkx at module level")
        if root == "triton":
            assert in_fn, "import triton inside the launching function"


def test_every_module_is_checked():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for must in ("desco_tpu_torch/serving.py",
                 "desco_tpu_torch/ops/cuda_segment.py",
                 "desco_tpu_torch/graph/atlas.py", "chip_smoke.py"):
        assert must in names
