"""Workload: graphs -> canonical-neighborhood samples -> gossip samples.

The serving part of desco_tpu's ``Workload`` (``desco_tpu/data/workload.py``),
copied so the port imports nothing of desco_tpu: neighborhood samples,
gossip samples and the graph-level aggregations. Serving sees each
graph once, so the disk caches and the ground-truth computation of the
training workload are left out; the order-3 tconv samples come from the
native C++ prep when it is available.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from ..batch.build import gossip_sample, neighborhood_sample
from ..batch.packed import GraphSample
from ..graph.canonical import Neighborhood, extract_all_neighborhoods
from ..graph.container import Graph
from ..truth import native as truth_native


@dataclasses.dataclass
class NeighborhoodIndex:
    index: np.ndarray      # (#neigh, 2) of (gid, vid)
    indicator: np.ndarray  # (#total_nodes,) bool


class Workload:
    def __init__(self, graphs: List[Graph]) -> None:
        self.graphs = graphs
        self.node_offsets = np.concatenate(
            [[0], np.cumsum([g.n_nodes for g in graphs])]).astype(np.int64)
        self.total_nodes = int(self.node_offsets[-1])

    # ---------------------------------------------------- neighborhoods
    def extract_neighborhoods(self, depth: int):
        """(neighborhoods, NeighborhoodIndex) via the native kernel when
        available (semantics of extract_all_neighborhoods)."""
        if not truth_native.native_available():
            neighs, index, indicator = extract_all_neighborhoods(
                self.graphs, depth)
            return neighs, NeighborhoodIndex(index, indicator)

        neighs, index, indicator = [], [], []
        for gid, g in enumerate(self.graphs):
            sizes, flat = truth_native.extract_neighborhoods_native(g, depth)
            off = 0
            for v in range(g.n_nodes):
                if sizes[v] == 0:
                    indicator.append(False)
                    continue
                nodes = flat[off:off + sizes[v]]
                off += sizes[v]
                sub, orig = g.induced_subgraph(nodes)
                neighs.append(Neighborhood(
                    graph=sub, canonical=len(nodes) - 1, nodes=orig,
                    gid=gid, vid=v))
                indicator.append(True)
                index.append((gid, v))
        return neighs, NeighborhoodIndex(
            np.array(index, dtype=np.int64).reshape(-1, 2),
            np.array(indicator, dtype=bool))

    def neighborhood_samples(
        self, depth: int,
        use_tconv: bool = True,
        truth: Optional[np.ndarray] = None,
        num_workers: Optional[int] = None,
        order: int = 3,
    ) -> tuple[List[GraphSample], NeighborhoodIndex]:
        """Canonical-neighborhood GraphSamples (the reference's
        NeighborhoodDataset), with ``truth`` rows attached as labels when
        given — serving passes zeros, as desco_tpu does."""
        if order == 3 and use_tconv and truth_native.native_available():
            samples, nindex = self._native_fast_samples(
                depth, num_workers=num_workers)
        else:
            neighs, nindex = self.extract_neighborhoods(depth)
            samples = [neighborhood_sample(nb, use_tconv=use_tconv,
                                           order=order)
                       for nb in neighs]
        if truth is not None:
            for s, (gid, vid) in zip(samples, nindex.index):
                s.y = truth[self.node_offsets[gid] + vid].astype(np.float32)
        return samples, nindex

    def _native_fast_samples(self, depth: int,
                             num_workers: Optional[int] = None):
        """6-type tconv samples via ONE fused C call per graph
        (native prepare_samples: partition + induced subgraph + triangle
        typing + directed expansion), thread-parallel across graphs (the
        C call releases the GIL). Identical to the generic path up to
        edge order (the packer re-sorts edges by (dst, type) anyway)."""
        from concurrent.futures import ThreadPoolExecutor

        workers = num_workers or os.cpu_count() or 1
        with ThreadPoolExecutor(max_workers=workers) as ex:
            per_graph = list(ex.map(
                lambda g: truth_native.prepare_samples_native(g, depth),
                self.graphs))
        samples, index, indicator = [], [], []
        for gid, (g, (sizes, esizes, nodes, src, dst, et)) in enumerate(
                zip(self.graphs, per_graph)):
            keep = sizes > 0
            indicator.append(keep)
            vids = np.nonzero(keep)[0]
            index.extend((gid, int(v)) for v in vids)
            no = np.concatenate([[0], np.cumsum(sizes[keep])])
            eo = np.concatenate([[0], np.cumsum(esizes[keep])])
            x_flat = np.zeros((len(nodes), 1), np.float32)
            nt_flat = np.zeros(len(nodes), np.int32)
            nt_flat[no[1:] - 1] = 1  # canonical node is last per slice
            for i in range(len(vids)):
                samples.append(GraphSample(
                    node_type=nt_flat[no[i]:no[i + 1]],
                    x=x_flat[no[i]:no[i + 1]],
                    edge_src=src[eo[i]:eo[i + 1]],
                    edge_dst=dst[eo[i]:eo[i + 1]],
                    edge_type=et[eo[i]:eo[i + 1]],
                ))
        return samples, NeighborhoodIndex(
            np.array(index, np.int64).reshape(-1, 2),
            np.concatenate(indicator) if indicator
            else np.zeros(0, bool))

    # ---------------------------------------------------------- gossip
    def gossip_samples(
        self, neigh_counts: np.ndarray, nindex: NeighborhoodIndex,
        truth: np.ndarray,
    ) -> List[GraphSample]:
        """Gossip GraphSamples over the ORIGINAL graphs; node features =
        stage-1 counts scattered via the indicator (zeros where the
        neighborhood was dropped), labels = truth."""
        n_q = truth.shape[1]
        x_all = np.zeros((self.total_nodes, n_q), dtype=np.float32)
        x_all[nindex.indicator] = neigh_counts.astype(np.float32)
        samples = []
        for gid, g in enumerate(self.graphs):
            lo, hi = self.node_offsets[gid], self.node_offsets[gid + 1]
            samples.append(gossip_sample(
                g, x_all[lo:hi], truth[lo:hi].astype(np.float32)))
        return samples

    # ------------------------------------------------------ aggregation
    def aggregate_neighborhood_counts(
        self, neigh_counts: np.ndarray, nindex: NeighborhoodIndex,
    ) -> np.ndarray:
        """(#graphs, Q): sum stage-1 neighborhood counts per graph."""
        out = np.zeros((len(self.graphs), neigh_counts.shape[1]),
                       dtype=np.float64)
        np.add.at(out, nindex.index[:, 0], neigh_counts)
        return out

    def aggregate_node_counts(self, node_counts: np.ndarray) -> np.ndarray:
        """(#graphs, Q): sum per-node counts per graph."""
        out = np.zeros((len(self.graphs), node_counts.shape[1]),
                       dtype=np.float64)
        gids = np.repeat(np.arange(len(self.graphs)),
                         [g.n_nodes for g in self.graphs])
        np.add.at(out, gids, node_counts)
        return out
