"""Nothing a run imports is JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's); the
reference and the generator import nothing of the program; the command
refuses to run without a CUDA device."""

import os
import subprocess
import sys

from h100bench.lib import harness
from h100bench.tests.conftest import REPO

ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV,
                          capture_output=True, text=True, timeout=900)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "desco_tpu_torch_x", sys)
    assert "desco_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "desco_tpu.ops", sys)
    assert "desco_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    code = (
        "import sys\n"
        "from h100bench.tests.conftest import run_tiny\n"
        "run_tiny('sage-r4.serve-32g', trace=True)\n"
        "run_tiny('sage-r4.train-b512', trace=True)\n"
        "from h100bench.lib import harness\n"
        "print('FOUND', harness.forbidden_modules())\n"
        "print('PORT', 'desco_tpu_torch' in sys.modules)\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout and "PORT True" in out.stdout


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        "import h100bench.reference.pipeline, h100bench.gen.syn1827\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print('TOPS', sorted(tops & {'desco_tpu_torch', 'desco_tpu', "
        "'jax', 'jaxlib', 'flax'}))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "TOPS []" in out.stdout
    for sub in ("reference", "gen"):
        d = os.path.join(harness.BENCH_DIR, sub)
        for fn in os.listdir(d):
            if fn.endswith(".py"):
                with open(os.path.join(d, fn)) as f:
                    text = f.read()
                assert "import desco" not in text and "from desco" not in text


def test_the_command_needs_a_card():
    out = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         "sage-r4.serve-32g", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=REPO, env=dict(ENV, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
