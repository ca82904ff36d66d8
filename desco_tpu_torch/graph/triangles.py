"""Triangle edge typing (Tconv) for SHMP.

An edge (u, v) is a *triangle* edge iff u and v share at least one common
neighbor — i.e. the edge closes at least one triangle; otherwise it is a
*tride* edge. This reproduces the reference's ``ToTconvHetero`` transform,
which computes ``A * (A @ A)`` with sparse matmuls and thresholds > 1 on
``A*A2 + A`` (transforms.py:168-255) —
here done with sorted-adjacency intersection on the host instead of
sparse-sparse matmul, which is both faster for these small neighborhoods
and has no GPU dependency.

Combined with node types {canonical, count} this yields the 6 SHMP edge
types of the order-3 heterogeneous convolution
(lightning_model.py:371-421).
"""

from __future__ import annotations

import numpy as np

from .container import Graph


def triangle_edge_mask(g: Graph) -> np.ndarray:
    """Boolean mask over ``g.edges`` (undirected, stored once): True iff
    the edge is part of >=1 triangle. Dispatches to the native C++ kernel
    when available (the Python loop below is the fallback/oracle)."""
    m = g.n_edges
    if m == 0:
        return np.zeros(0, dtype=bool)
    try:
        from ..truth.native import native_available, triangle_mask_native

        # native wins at every size (~6x even on <=32-edge graphs:
        # the per-edge searchsorted loop below costs more than the
        # ctypes call overhead)
        if native_available():
            return triangle_mask_native(g)
    except ImportError:  # pragma: no cover
        pass
    indptr, indices = g.csr()  # neighbor lists sorted ascending
    mask = np.zeros(m, dtype=bool)
    deg = np.diff(indptr)
    for i in range(m):
        u, v = int(g.edges[i, 0]), int(g.edges[i, 1])
        # intersect sorted neighbor lists; True if nonempty
        a = indices[indptr[u]:indptr[u + 1]]
        b = indices[indptr[v]:indptr[v + 1]]
        if deg[u] > deg[v]:
            a, b = b, a
        # a is the shorter list; binary-search each element in b
        pos = np.searchsorted(b, a)
        pos[pos >= b.size] = b.size - 1 if b.size else 0
        if b.size and np.any(b[pos] == a):
            mask[i] = True
    return mask

