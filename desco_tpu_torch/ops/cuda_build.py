"""Building the port's CUDA libraries with nvcc, at first use.

Each library is one ``csrc/*.cu`` source with a plain C interface,
compiled for ``sm_90a`` into ``desco_tpu_torch/build/kernels/`` (listed in
.gitignore) and loaded with ctypes. The file name carries a digest of the
source, of the sources it includes and of the flags, and the rename into
place is atomic, so concurrent processes share one build and an edited
source never meets a stale library. Nothing here touches CUDA or nvcc
when the module is imported.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# stem -> (source, the sources it #includes), relative to csrc/
LIBRARIES: Dict[str, Tuple[str, Sequence[str]]] = {
    "desco_segment": ("segment_sum.cu", ()),
    "desco_typed": ("typed_aggregate.cu", ()),
    "desco_segment_probe": ("segment_sum_probe.cu", ("segment_sum.cu",)),
}

# seconds the last build of each library took in this process (0: cached)
build_seconds: Dict[str, float] = {}


def source_path(stem: str) -> str:
    return os.path.join(CSRC_DIR, LIBRARIES[stem][0])


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "desco_tpu_torch are built from desco_tpu_torch/csrc/*.cu at "
        "first use")


def build(stem: str) -> str:
    """Compile library ``stem`` if its sources and these flags have no
    build yet; return the path of the shared library."""
    source, deps = LIBRARIES[stem]
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in (source, *deps):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    so_path = os.path.join(BUILD_DIR,
                           f"lib{stem}-{digest.hexdigest()[:12]}.so")
    if os.path.exists(so_path) and os.path.getsize(so_path) > 0:
        build_seconds.setdefault(stem, 0.0)
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    src = os.path.join(CSRC_DIR, source)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_seconds[stem] = time.perf_counter() - t0
    return so_path


def build_all() -> Dict[str, str]:
    """Build every library, one nvcc per source, all started together."""
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        futures = {stem: pool.submit(build, stem) for stem in LIBRARIES}
        return {stem: f.result() for stem, f in futures.items()}
