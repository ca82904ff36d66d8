"""ctypes binding to the native host library (``native/desco_host.cpp``).

The port shares the C++ source with desco_tpu and leaves it untouched:
it compiles it with g++ into its OWN build directory
(``desco_tpu_torch/build/native/``, listed in .gitignore) on first use,
never into ``native/``. The library name carries a digest of the source
and the flags, so a stale or foreign build is never loaded. The flags
omit ``-march=native``: the build directory may travel with a copy of
the tree to another machine.

Every entry point has a pure-Python fallback (``truth/vf2.py``,
``graph/``) used when no C++ toolchain is available; ``engine()`` says
which one runs. The C calls release the GIL, so
``parallel_canonical_counts`` gets real multicore speedup from a plain
thread pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from ..graph.container import Graph

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_PATH = os.path.join(os.path.dirname(_PKG_DIR), "native",
                         "desco_host.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "build", "native")
_CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib = None
_lib_failed = False
_lock = threading.Lock()


def _build() -> str:
    """Compile the shared source into the port's build directory (atomic
    rename, so concurrent processes never load a half-written file)."""
    with open(_SRC_PATH, "rb") as f:
        src = f.read()
    tag = hashlib.sha1(src + " ".join(_CXXFLAGS).encode()).hexdigest()[:12]
    so_path = os.path.join(_BUILD_DIR, f"libdesco_host-{tag}.so")
    if os.path.exists(so_path) and os.path.getsize(so_path) > 0:
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_CXXFLAGS, "-o", tmp, _SRC_PATH],
                       check=True, capture_output=True)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
            lib.vf2_count.restype = ctypes.c_longlong
            lib.vf2_count.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_longlong),
            ]
            lib.extract_neighborhoods.restype = ctypes.c_longlong
            lib.extract_neighborhoods.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.triangle_mask.restype = None
            lib.triangle_mask.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_ubyte),
            ]
            lib.prepare_samples.restype = ctypes.c_longlong
            lib.prepare_samples.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            lib.desco_host_abi_version.restype = ctypes.c_int
            if lib.desco_host_abi_version() != 1:
                raise RuntimeError("desco_host ABI version mismatch")
            _lib = lib
        except (OSError, subprocess.CalledProcessError, RuntimeError,
                AttributeError) as e:
            # fail OPEN to the pure-Python path, but never silently: the
            # fallback is orders of magnitude slower
            import warnings

            detail = getattr(e, "stderr", b"") or b""
            warnings.warn(
                f"native desco_host library unavailable ({type(e).__name__}:"
                f" {e} {detail.decode(errors='replace')[-500:]}) — falling "
                f"back to the pure-Python VF2 path", stacklevel=2)
            _lib_failed = True
        return _lib


def native_available() -> bool:
    return load_library() is not None


def engine() -> str:
    """'native' (C++ VF2 and sample prep) or 'python' (the fallback)."""
    return "native" if native_available() else "python"


def _edges_ptr(g: Graph):
    e = np.ascontiguousarray(g.edges, dtype=np.int32)
    return e, e.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def vf2_count_native(
    target: Graph, query: Graph,
    per_node: Optional[np.ndarray] = None,
) -> int:
    """Induced embeddings of ``query`` in ``target`` (unlabeled; the
    port's serving slice has no labeled mode). ``per_node`` (int64,
    len n_target) accumulates each embedding at its max target node."""
    lib = load_library()
    te, tp = _edges_ptr(target)
    qe, qp = _edges_ptr(query)
    pn = (per_node.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))
          if per_node is not None else None)
    return int(lib.vf2_count(
        target.n_nodes, target.n_edges, tp,
        query.n_nodes, query.n_edges, qp, None, None, pn))


def symmetric_factor_native(query: Graph) -> int:
    return vf2_count_native(query, query)


def parallel_canonical_counts(
    targets: Sequence[Graph], queries: Sequence[Graph],
    num_workers: Optional[int] = None,
) -> List[np.ndarray]:
    """Canonical counts per target, thread-parallel over (target, query)
    tasks (GIL released inside the C call)."""
    from .vf2 import canonical_counts as py_canonical_counts

    if not native_available():
        return [py_canonical_counts(t, list(queries)) for t in targets]

    sf = [symmetric_factor_native(q) for q in queries]
    num_workers = num_workers or os.cpu_count() or 1
    results = [np.zeros((t.n_nodes, len(queries)), np.float64)
               for t in targets]

    def task(ti_qi):
        ti, qi = ti_qi
        per = np.zeros(targets[ti].n_nodes, dtype=np.int64)
        vf2_count_native(targets[ti], queries[qi], per)
        results[ti][:, qi] = per / sf[qi]

    tasks = [(ti, qi) for ti in range(len(targets))
             for qi in range(len(queries))]
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        list(ex.map(task, tasks))
    return results


def extract_neighborhoods_native(g: Graph, depth: int):
    """(sizes, flat_nodes): sizes[v] = neighborhood size (0 = dropped);
    flat_nodes concatenates each surviving neighborhood's sorted node
    list (ascending ids; v last)."""
    lib = load_library()
    e, ep = _edges_ptr(g)
    sizes = np.zeros(g.n_nodes, dtype=np.int32)
    total = lib.extract_neighborhoods(
        g.n_nodes, g.n_edges, ep,
        depth, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), None)
    flat = np.zeros(int(total), dtype=np.int32)
    lib.extract_neighborhoods(
        g.n_nodes, g.n_edges, ep, depth,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return sizes, flat


def prepare_samples_native(g: Graph, depth: int):
    """Fused canonical partition + SHMP tconv sample prep (one C call
    per graph; see native/desco_host.cpp prepare_samples). Returns
    (sizes, esizes, flat_nodes, flat_src, flat_dst, flat_etype) —
    per-neighborhood slices are delimited by cumsum(sizes)/cumsum(esizes)
    over the surviving (sizes > 0) rows, in node-id order."""
    lib = load_library()
    e, ep = _edges_ptr(g)
    sizes = np.zeros(g.n_nodes, dtype=np.int32)
    esizes = np.zeros(g.n_nodes, dtype=np.int64)
    null_i = ctypes.POINTER(ctypes.c_int)()
    total_n = lib.prepare_samples(
        g.n_nodes, g.n_edges, ep, depth,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        esizes.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        null_i, null_i, null_i, null_i)
    total_e = int(esizes.sum())
    nodes = np.zeros(int(total_n), dtype=np.int32)
    src = np.zeros(total_e, dtype=np.int32)
    dst = np.zeros(total_e, dtype=np.int32)
    etype = np.zeros(total_e, dtype=np.int32)

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    lib.prepare_samples(
        g.n_nodes, g.n_edges, ep, depth,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        esizes.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ip(nodes), ip(src), ip(dst), ip(etype))
    return sizes, esizes, nodes, src, dst, etype


def triangle_mask_native(g: Graph) -> np.ndarray:
    lib = load_library()
    e, ep = _edges_ptr(g)
    out = np.zeros(g.n_edges, dtype=np.uint8)
    lib.triangle_mask(
        g.n_nodes, g.n_edges, ep,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return out.astype(bool)
