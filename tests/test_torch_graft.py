"""desco_tpu_torch's build cache (utils/compile_cache.py) and entry points
(graft_entry.py) against desco_tpu's, on the CPU.

The cache tests mirror tests/test_compile_cache.py: the directories are
pointed, a build lands there, a second call re-points. The port builds
its native host library with g++ here (its CUDA kernels need nvcc and a
card; chip_smoke.py checks those). ``entry()`` runs desco_tpu's tiny
flagship forward with desco_tpu's weights carried over
(``params_from_jax``), within the serving tolerance (rtol 1e-3, atol
1e-2, tests/test_torch_serving.py); ``dryrun_multichip(4)`` runs desco_tpu's
multi-chip drill over 4 replicas on the CPU."""

import os

import numpy as np
import jax
import pytest
import torch

from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch import graft_entry
from desco_tpu_torch.ops import cuda_build
from desco_tpu_torch.train.checkpoint import params_from_jax
from desco_tpu_torch.truth import native
from desco_tpu_torch.utils.compile_cache import enable_compilation_cache

from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def restore_build_dirs(monkeypatch):
    """Put both build directories back after the test."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(native, "_BUILD_DIR", native._BUILD_DIR)


def test_enable_points_both_build_dirs_and_persists(tmp_path,
                                                    restore_build_dirs):
    d = str(tmp_path / "cache")
    out = enable_compilation_cache(d, min_compile_secs=0.0)
    assert out == os.path.abspath(d) and os.path.isdir(d)
    assert cuda_build.BUILD_DIR == os.path.join(out, "kernels")
    assert native._BUILD_DIR == os.path.join(out, "native")
    so = native._build()  # g++ into the cache
    assert so.startswith(os.path.join(out, "native"))
    stamp = os.stat(so).st_mtime_ns
    assert native._build() == so and os.stat(so).st_mtime_ns == stamp


def test_repoint_is_safe(tmp_path, restore_build_dirs):
    a = enable_compilation_cache(str(tmp_path / "a"))
    b = enable_compilation_cache(str(tmp_path / "b"))
    assert a != b
    assert cuda_build.BUILD_DIR == os.path.join(b, "kernels")
    assert native._BUILD_DIR == os.path.join(b, "native")


def test_service_takes_a_compile_cache(tmp_path, restore_build_dirs):
    from desco_tpu_torch.serving import CountingService

    CountingService("release/r4/neigh.best", device="cpu",
                    compile_cache=str(tmp_path / "c"))
    assert cuda_build.BUILD_DIR == str(tmp_path / "c" / "kernels")


def test_entry_matches_desco_tpu():
    import __graft_entry__ as jentry

    jfn, (jparams, jbatch, jqb) = jentry.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jbatch, jqb))
    fn, (params, batch, qb) = graft_entry.entry("cpu")
    own = fn(params, batch, qb)
    assert own.shape == want.shape and torch.isfinite(own).all()
    tparams = params_from_jax(_flatten(jparams)).requires_grad_(False)
    got = fn(tparams, batch, qb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)
    if not torch.cuda.is_available():  # the default device is the GPU
        with pytest.raises(RuntimeError, match="CUDA"):
            graft_entry.entry()


def test_dryrun_multichip_runs_on_cpu(capsys):
    out = graft_entry.dryrun_multichip(4, device="cpu")
    for key in ("neighborhood_loss", "gossip_loss", "halo_train_loss",
                "dp_halo_loss"):
        assert np.isfinite(out[key]), key
    assert len(out["halo_forward"]) == 4
    assert "OK" in capsys.readouterr().out
