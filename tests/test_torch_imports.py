"""desco_tpu_torch stands alone: no file of it (nor chip_smoke.py) imports
jax, flax, optax, desco_tpu, sklearn or matplotlib (the port runs where
none of them is installed), and networkx only inside a function (the
test-only ``Graph.to_networkx``, the ground-truth tool's pickle of
networkx graphs). Checked on the source: this process has jax
preloaded, so sys.modules cannot tell."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "desco_tpu", "sklearn",
             "matplotlib"}
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
                 "desco_tpu_torch/ops/cuda_build.py",
                 "desco_tpu_torch/bench.py",
                 "desco_tpu_torch/tools/segsum_inner_ablation.py",
                 "desco_tpu_torch/tools/serving_profile.py",
                 "desco_tpu_torch/graph/atlas.py",
                 "desco_tpu_torch/graph/atlas_data.py",
                 "desco_tpu_torch/tools/serving_bench.py",
                 "desco_tpu_torch/tools/compute_groundtruth.py",
                 "desco_tpu_torch/tools/verify_sweep.py",
                 "desco_tpu_torch/tools/scaling.py",
                 "desco_tpu_torch/tools/large_graph_serving.py",
                 "desco_tpu_torch/tools/runtime.py",
                 "desco_tpu_torch/tools/complexity_analysis.py",
                 "desco_tpu_torch/tools/downstream_task.py",
                 "desco_tpu_torch/tools/dataset_statistics.py",
                 "desco_tpu_torch/data/nx_subset.py",
                 "desco_tpu_torch/data/tu_proxy.py",
                 "desco_tpu_torch/data/datasets.py",
                 "desco_tpu_torch/gen_dataset.py",
                 "desco_tpu_torch/baseline.py",
                 "desco_tpu_torch/models/diamnet.py",
                 "desco_tpu_torch/models/baseline_diamnet.py",
                 "desco_tpu_torch/models/lrp.py",
                 "desco_tpu_torch/utils/mining.py",
                 "desco_tpu_torch/utils/distributed.py",
                 "desco_tpu_torch/parallel/__init__.py",
                 "desco_tpu_torch/parallel/halo.py",
                 "desco_tpu_torch/parallel/overlap_check.py",
                 "chip_smoke.py"):
        assert must in names


def test_data_layer_runs_without_networkx(tmp_path):
    """The generators, the proxies and the loader in a process where
    ``import networkx`` fails, as on a machine without it."""
    code = (
        "import sys; sys.modules['networkx'] = None\n"
        "from desco_tpu_torch.data import synthetic, tu_proxy\n"
        "from desco_tpu_torch.data.datasets import fingerprint, load_data\n"
        "from desco_tpu_torch import gen_dataset\n"
        "synthetic.generate_synthetic(12, 10, 60, seed=1)\n"
        "synthetic.generate_combined_syn(12, seed=1)\n"
        "for fn, _, kw in tu_proxy.TU_PROXY_RECIPES.values():\n"
        "    fn(3, seed=0, **kw)\n"
        f"print(fingerprint(load_data('Syn_64_test', {str(tmp_path)!r})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len(proc.stdout.strip()) == 16
