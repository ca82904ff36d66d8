"""Workload: graphs -> ground truth -> canonical-neighborhood samples ->
gossip samples.

desco_tpu's ``Workload`` (``desco_tpu/data/workload.py``), copied so the
port imports nothing of desco_tpu: exact canonical-count ground truth
(cached on disk under ``root``, keyed by the query-set signature),
neighborhood samples, gossip samples and the graph-level aggregations.
The order-3 tconv samples come from the native C++ prep when it is
available. Left out (ROADMAP.md, Queue 1): the neighborhood sample
cache, the truth shards of multi-host materialization and the labeled
truth.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

from ..batch.build import gossip_sample, neighborhood_sample
from ..batch.packed import GraphSample
from ..graph.atlas import gen_queries as atlas_queries
from ..graph.canonical import Neighborhood, extract_all_neighborhoods
from ..graph.container import Graph
from ..truth import native as truth_native


def _query_signature(query_ids: Sequence[int], max_len: int = 30) -> str:
    """Cache-file stem of a query set (desco_tpu's convention): a readable
    prefix of the first ``max_len`` ids, plus a digest of the whole set
    when it is longer, so two long sets that share a prefix and a length
    do not collide."""
    ids = list(query_ids)
    sig = ("query_num_{:d}_atlas_ids_".format(len(ids))
           + "_".join(map(str, ids[:max_len])))
    if len(ids) > max_len:
        import hashlib

        digest = hashlib.sha1(
            ",".join(map(str, ids)).encode()).hexdigest()[:10]
        sig += "_h" + digest
    return sig


@dataclasses.dataclass
class NeighborhoodIndex:
    index: np.ndarray      # (#neigh, 2) of (gid, vid)
    indicator: np.ndarray  # (#total_nodes,) bool


class Workload:
    def __init__(self, graphs: List[Graph], root: Optional[str] = None,
                 name: str = "dataset") -> None:
        """``root``: directory of this dataset's disk caches; None (a
        serving request) keeps nothing on disk."""
        self.graphs = graphs
        self.root = root
        self.name = name
        self.node_offsets = np.concatenate(
            [[0], np.cumsum([g.n_nodes for g in graphs])]).astype(np.int64)
        self.total_nodes = int(self.node_offsets[-1])

    # ------------------------------------------------------------ truth
    def groundtruth_path(self, query_ids: Sequence[int]) -> str:
        if self.root is None:
            raise ValueError("this Workload has no root for disk caches")
        return os.path.join(self.root, "CanonicalCountTruth",
                            _query_signature(query_ids) + ".npy")

    def compute_groundtruth(
        self, query_ids: Sequence[int],
        queries: Optional[List[Graph]] = None,
        num_workers: Optional[int] = None,
        use_cache: bool = True,
    ) -> np.ndarray:
        """(total_nodes, n_queries) float64 canonical counts, by the
        native C++ VF2 (thread-parallel) or its Python twin; cached as
        ``.npy`` under ``root`` when there is one."""
        use_cache = use_cache and self.root is not None
        if use_cache:
            path = self.groundtruth_path(query_ids)
            if os.path.exists(path):
                truth = np.load(path)
                if truth.shape == (self.total_nodes, len(query_ids)):
                    return truth
        if queries is None:
            queries = atlas_queries(list(query_ids))
        per_graph = truth_native.parallel_canonical_counts(
            self.graphs, queries, num_workers)
        truth = np.concatenate(per_graph, axis=0).astype(np.float64)
        if use_cache:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, truth)
        return truth

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
