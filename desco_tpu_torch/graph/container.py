"""Host-side graph container (a copy of ``desco_tpu/graph/container.py``:
the port imports nothing of desco_tpu).

A minimal, numpy-native undirected graph with CSR adjacency — the host-side
workhorse replacing the reference's networkx graphs on the hot paths
(canonical partition, triangle typing, ground truth). The reference keeps
graphs as ``nx.Graph`` end to end (e.g. its data.py:353-396); the port
never touches networkx.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """Undirected simple graph on nodes ``0..n_nodes-1``.

    ``edges`` is an ``(m, 2)`` int32 array of *undirected* edges stored once,
    with no self loops and no duplicates (u < v canonical order is not
    required but encouraged). Node features, if present, are ``(n, f)``.
    """

    n_nodes: int
    edges: np.ndarray  # (m, 2) int32
    node_feat: Optional[np.ndarray] = None  # (n, f) float32 or None

    # lazily built CSR adjacency
    _indptr: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    _indices: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        e = np.asarray(self.edges, dtype=np.int32)
        if e.size == 0:
            e = np.zeros((0, 2), dtype=np.int32)
        self.edges = e.reshape(-1, 2)

    # ------------------------------------------------------------------ #
    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    def csr(self):
        """Return (indptr, indices) of the symmetric adjacency, neighbor
        lists sorted ascending. Built once and cached."""
        if self._indptr is None:
            n = self.n_nodes
            if self.n_edges == 0:
                self._indptr = np.zeros(n + 1, dtype=np.int64)
                self._indices = np.zeros(0, dtype=np.int32)
            else:
                src = np.concatenate([self.edges[:, 0], self.edges[:, 1]])
                dst = np.concatenate([self.edges[:, 1], self.edges[:, 0]])
                order = np.lexsort((dst, src))
                src, dst = src[order], dst[order]
                counts = np.bincount(src, minlength=n)
                self._indptr = np.concatenate(
                    [[0], np.cumsum(counts)]).astype(np.int64)
                self._indices = dst.astype(np.int32)
        return self._indptr, self._indices

    def neighbors(self, v: int) -> np.ndarray:
        indptr, indices = self.csr()
        return indices[indptr[v]:indptr[v + 1]]

    def degrees(self) -> np.ndarray:
        indptr, _ = self.csr()
        return np.diff(indptr).astype(np.int32)

    # ------------------------------------------------------------------ #
    def induced_subgraph(self, nodes: np.ndarray) -> tuple["Graph", np.ndarray]:
        """Induced subgraph on ``nodes`` (any order). Returns the subgraph
        with nodes relabeled ``0..k-1`` in the order given, plus the node
        list actually used (== ``nodes``)."""
        nodes = np.asarray(nodes, dtype=np.int32)
        relabel = np.full(self.n_nodes, -1, dtype=np.int32)
        relabel[nodes] = np.arange(len(nodes), dtype=np.int32)
        if self.n_edges:
            a = relabel[self.edges[:, 0]]
            b = relabel[self.edges[:, 1]]
            keep = (a >= 0) & (b >= 0)
            sub_edges = np.stack([a[keep], b[keep]], axis=1)
        else:
            sub_edges = np.zeros((0, 2), dtype=np.int32)
        feat = self.node_feat[nodes] if self.node_feat is not None else None
        return Graph(len(nodes), sub_edges, feat), nodes

    def connected_component_of(self, v: int) -> np.ndarray:
        """Node set (sorted) of the connected component containing ``v``."""
        indptr, indices = self.csr()
        seen = np.zeros(self.n_nodes, dtype=bool)
        seen[v] = True
        frontier = np.array([v], dtype=np.int32)
        while frontier.size:
            # gather all neighbors of the frontier
            nbrs = np.concatenate(
                [indices[indptr[u]:indptr[u + 1]] for u in frontier]
            ) if frontier.size else np.zeros(0, dtype=np.int32)
            nbrs = nbrs[~seen[nbrs]]
            if nbrs.size == 0:
                break
            nbrs = np.unique(nbrs)
            seen[nbrs] = True
            frontier = nbrs
        return np.nonzero(seen)[0].astype(np.int32)
