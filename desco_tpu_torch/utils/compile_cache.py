"""Persistent build cache — the port of
``desco_tpu/utils/compile_cache.py``.

desco_tpu points JAX's persistent compilation cache at a directory, so a
restarted serving process (or a second run of the same training config)
loads the executables an earlier process compiled instead of compiling
them again. The port compiles nothing at run time but its native
libraries: the CUDA kernels (``ops/cuda_build.py``, nvcc) and the host
library (``truth/native.py``, g++). Both are keyed by a digest of their
sources and flags and renamed into place atomically, so a directory
shared by several processes is safe. ``enable_compilation_cache`` points
both build directories into ``cache_dir``: a process that finds its
libraries there loads them without running a compiler.

Safe to call more than once; a later call with another directory
re-points both.
"""

from __future__ import annotations

import os


def enable_compilation_cache(cache_dir: str,
                             min_compile_secs: float = 0.5) -> str:
    """Build and load the port's libraries under ``cache_dir``
    (``kernels/`` for nvcc, ``native/`` for g++). Returns the absolute
    path.

    ``min_compile_secs`` keeps desco_tpu's signature and has no effect
    here: the libraries are loaded from the files they were built into,
    so every build is kept, and each takes seconds of nvcc or g++, above
    desco_tpu's 0.5 s threshold anyway. Call it before the first kernel
    launch: a library this process has loaded already stays loaded from
    where it was built."""
    del min_compile_secs
    path = os.path.abspath(os.path.expanduser(cache_dir))
    os.makedirs(path, exist_ok=True)
    from ..ops import cuda_build
    from ..truth import native

    cuda_build.BUILD_DIR = os.path.join(path, "kernels")
    native._BUILD_DIR = os.path.join(path, "native")
    return path
