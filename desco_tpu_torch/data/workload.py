"""Workload: graphs -> ground truth -> canonical-neighborhood samples ->
gossip samples.

desco_tpu's ``Workload`` (``desco_tpu/data/workload.py``), copied so the
port imports nothing of desco_tpu: exact canonical-count ground truth
(cached on disk under ``root``, keyed by the query-set signature), the
truth shards of multi-host materialization, neighborhood samples with
their disk cache, gossip samples and the graph-level aggregations. The
order-3 tconv samples come from the native C++ prep when it is
available; order-4 (orbit) typing and the homogeneous ablation's samples
take the generic path. The whole-graph samples of the
no-canonical-partition ablation are ``wo_canonical_samples``; labeled
mode has its own truth (``compute_groundtruth_labeled``, label-preserving
VF2) and featured samples (``use_node_feat``). Both caches use
desco_tpu's file names and formats, so either package reads the
other's.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from ..batch.build import (
    gossip_sample,
    homogeneous_neighborhood_sample,
    neighborhood_sample,
)
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


def _labeled_query_signature(queries, q_labels) -> str:
    """Cache-file stem of labeled truth: a digest of the full query
    structure (edges and label assignment per query), since a count and a
    summed size alone collide across label expansions of same-shaped
    query sets."""
    import hashlib

    h = hashlib.sha1()
    for q, ql in zip(queries, q_labels):
        h.update(np.int64(q.n_nodes).tobytes())
        e = np.asarray(q.edges, np.int64).reshape(-1, 2)
        h.update(e[np.lexsort((e[:, 1], e[:, 0]))].tobytes())
        h.update(np.asarray(ql, np.int64).tobytes())
    return ("query_num_{:d}_node_feat_h{}"
            .format(len(queries), h.hexdigest()[:12]))


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
        # seconds the last generic sample build spent typing edges
        # (order-4 orbit typing is pure Python: main.py prints it)
        self.typing_seconds: Optional[float] = None

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

    def compute_groundtruth_labeled(
        self, queries: List[Graph],
        num_workers: Optional[int] = None,
        use_cache: bool = True,
    ) -> np.ndarray:
        """(total_nodes, len(queries)) float64 canonical counts under node
        label matching (labeled mode): ``queries`` and the graphs carry
        one-hot ``node_feat``, the labels are its argmax. Cached as
        ``.npy`` under ``root`` beside the unlabeled truth, keyed by
        ``_labeled_query_signature``."""
        use_cache = use_cache and self.root is not None
        if use_cache:
            q_labels = [truth_native.labels_of(q) for q in queries]
            path = os.path.join(
                self.root, "CanonicalCountTruth",
                _labeled_query_signature(queries, q_labels) + ".npy")
            if os.path.exists(path):
                truth = np.load(path)
                if truth.shape == (self.total_nodes, len(queries)):
                    return truth
        per_graph = truth_native.parallel_labeled_counts(
            self.graphs, queries, num_workers)
        truth = (np.concatenate(per_graph, axis=0) if per_graph
                 else np.zeros((0, len(queries)), np.float64))
        if use_cache:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.save(path, truth)
        return truth

    # ------------------------------------------- multi-host truth shards
    def shard_path(self, query_ids: Sequence[int], shard: int,
                   num_shards: int) -> str:
        return os.path.join(
            self.root, "CanonicalCountTruth",
            _query_signature(query_ids)
            + f".shard{shard}of{num_shards}.npz")

    def compute_groundtruth_shard(
        self, query_ids: Sequence[int], shard: int, num_shards: int,
        queries: Optional[List[Graph]] = None,
        num_workers: Optional[int] = None,
    ) -> str:
        """Exact truth for the graphs with ``gi % num_shards == shard``,
        saved as a partial file (one shard per host);
        ``merge_groundtruth_shards`` assembles the canonical cache.
        Returns the shard file path."""
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} not in [0, {num_shards})")
        if queries is None:
            queries = atlas_queries(list(query_ids))
        idx = list(range(shard, len(self.graphs), num_shards))
        per_graph = truth_native.parallel_canonical_counts(
            [self.graphs[gi] for gi in idx], queries, num_workers)
        path = self.shard_path(query_ids, shard, num_shards)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, **{str(gi): arr
                          for gi, arr in zip(idx, per_graph)})
        return path

    def merge_groundtruth_shards(
        self, query_ids: Sequence[int], num_shards: int,
    ) -> np.ndarray:
        """Assemble shard files into the full (total_nodes, Q) truth and
        write the canonical cache (so later runs hit the normal path).
        Raises if any shard file or graph is missing."""
        out = np.zeros((self.total_nodes, len(query_ids)), np.float64)
        seen = np.zeros(len(self.graphs), bool)
        for k in range(num_shards):
            path = self.shard_path(query_ids, k, num_shards)
            if not os.path.exists(path):
                raise FileNotFoundError(f"missing truth shard: {path}")
            with np.load(path) as z:
                for key in z.files:
                    gi = int(key)
                    lo = self.node_offsets[gi]
                    hi = self.node_offsets[gi + 1]
                    out[lo:hi] = z[key]
                    seen[gi] = True
        if not seen.all():
            missing = np.nonzero(~seen)[0][:5].tolist()
            raise ValueError(f"graphs missing from shards: {missing}...")
        cache = self.groundtruth_path(query_ids)
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.save(cache, out)
        return out

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

    def _neigh_cache_path(self, depth, use_tconv, use_hetero=True,
                          use_node_feat=False, order=3) -> str:
        """desco_tpu's sample-cache directory, keyed by depth and the
        typing and feature flags."""
        suffix = ("" if use_hetero else "_homo") + (
            "_tconv" if use_tconv else "") + (
            "_node_feat" if use_node_feat else "") + (
            f"_order{order}" if order != 3 else "")
        return os.path.join(
            self.root, "NeighborhoodDataset",
            f"neighs_depth_{depth}{suffix}")

    def neighborhood_samples(
        self, depth: int,
        use_tconv: bool = True,
        truth: Optional[np.ndarray] = None,
        num_workers: Optional[int] = None,
        order: int = 3,
        use_cache: bool = False,
        use_hetero: bool = True,
        use_node_feat: bool = False,
    ) -> tuple[List[GraphSample], NeighborhoodIndex]:
        """Canonical-neighborhood GraphSamples (the reference's
        NeighborhoodDataset), with ``truth`` rows attached as labels when
        given — serving passes zeros, as desco_tpu does. ``order=4`` types
        edges by 4-node orbit class x canonical combo (33 types,
        graph/orbits.py: exact enumeration in host Python, molecular
        scale); ``use_hetero=False`` builds the homogeneous ablation's
        one-type samples. ``use_node_feat`` (labeled mode) takes each
        node's one-hot ``node_feat`` as its input feature; its ``truth``
        is the labeled one (``compute_groundtruth_labeled``). ``use_cache``
        (needs a ``root``) reads the
        samples' structure from desco_tpu's sample cache, or writes it
        there after building it; a cache that does not fit the graphs (a
        dataset regenerated in the same root) is rebuilt with a
        warning."""
        if use_node_feat and not use_hetero:
            raise ValueError(
                "use_node_feat=True with use_hetero=False is "
                "unsupported: the homogeneous sample builder carries no "
                "node features, so labels would be silently dropped")
        use_cache = use_cache and self.root is not None
        samples = None
        if use_cache:
            cache = self._neigh_cache_path(depth, use_tconv, use_hetero,
                                           use_node_feat, order)
            if os.path.exists(cache):
                samples, nindex = self._load_neigh_cache(cache)
                if not self._cache_fits(nindex):
                    import warnings

                    warnings.warn(
                        f"neighborhood cache at {cache} does not match the "
                        f"current dataset (stale after regeneration?) — "
                        f"recomputing", stacklevel=2)
                    samples = None
        if samples is None:
            if (order == 3 and use_hetero and use_tconv
                    and truth_native.native_available()):
                samples, nindex = self._native_fast_samples(
                    depth, use_node_feat, num_workers=num_workers)
            else:
                neighs, nindex = self.extract_neighborhoods(depth)
                t0 = time.perf_counter()
                samples = [neighborhood_sample(
                               nb, use_tconv=use_tconv, order=order,
                               x=(self.graphs[nb.gid].node_feat[nb.nodes]
                                  if use_node_feat else None))
                           if use_hetero
                           else homogeneous_neighborhood_sample(nb)
                           for nb in neighs]
                self.typing_seconds = time.perf_counter() - t0
            if use_cache:
                self._save_neigh_cache(cache, samples, nindex)
        if truth is not None:
            for s, (gid, vid) in zip(samples, nindex.index):
                s.y = truth[self.node_offsets[gid] + vid].astype(np.float32)
        return samples, nindex

    def _cache_fits(self, nindex: NeighborhoodIndex) -> bool:
        """Whether a cached index can belong to these graphs: a stale
        cache's (gid, vid) rows would index the new truth — IndexError at
        best, silently wrong labels at worst."""
        idx = np.asarray(nindex.index)
        return not (len(nindex.indicator) != self.total_nodes
                    or (len(idx)
                        and (idx[:, 0].max() >= len(self.graphs)
                             or np.any(self.node_offsets[idx[:, 0]]
                                       + idx[:, 1] >= self.total_nodes))))

    def _native_fast_samples(self, depth: int, use_node_feat: bool = False,
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
            x_flat = (g.node_feat[nodes].astype(np.float32)
                      if use_node_feat
                      else np.zeros((len(nodes), 1), np.float32))
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

    def _save_neigh_cache(self, path, samples, nindex) -> None:
        """A directory of raw ``.npy`` files, one per field (desco_tpu's
        format); they load back as file-backed memmaps."""
        from ..utils.memory import prefault

        os.makedirs(path, exist_ok=True)

        def cat(parts, dtype, width=None):
            # concatenate into a prefaulted buffer (a fresh allocation
            # faults its pages in one at a time)
            if not parts:
                return (np.zeros(0, dtype) if width is None
                        else np.zeros((0, width), dtype))
            total = sum(len(p) for p in parts)
            shape = (total,) if width is None else (total, width)
            out = np.empty(shape, dtype)
            prefault(out)
            off = 0
            for p in parts:
                out[off:off + len(p)] = p
                off += len(p)
            return out

        fields = {
            "n_nodes": np.array([s.n_nodes for s in samples], np.int32),
            "n_edges": np.array([s.n_edges for s in samples], np.int32),
            "node_type": cat([s.node_type for s in samples], np.int32),
            "x": cat([s.x for s in samples], np.float32,
                     width=samples[0].x.shape[1] if samples else 1),
            "edge_src": cat([s.edge_src for s in samples], np.int32),
            "edge_dst": cat([s.edge_dst for s in samples], np.int32),
            "edge_type": cat([s.edge_type for s in samples], np.int32),
            "index": nindex.index, "indicator": nindex.indicator,
        }
        for k, v in fields.items():
            np.save(os.path.join(path, k + ".npy"), v)

    def _load_neigh_cache(self, path):
        def ld(k, mmap=True):
            return np.load(os.path.join(path, k + ".npy"),
                           mmap_mode="r" if mmap else None)

        n_nodes = np.asarray(ld("n_nodes", mmap=False))
        n_edges = np.asarray(ld("n_edges", mmap=False))
        no = np.concatenate([[0], np.cumsum(n_nodes)])
        eo = np.concatenate([[0], np.cumsum(n_edges)])
        nt, x = ld("node_type"), ld("x")
        es, ed, et = ld("edge_src"), ld("edge_dst"), ld("edge_type")
        samples = []
        for i in range(len(n_nodes)):
            samples.append(GraphSample(
                node_type=nt[no[i]:no[i + 1]],
                x=x[no[i]:no[i + 1]],
                edge_src=es[eo[i]:eo[i + 1]],
                edge_dst=ed[eo[i]:eo[i + 1]],
                edge_type=et[eo[i]:eo[i + 1]],
            ))
        return samples, NeighborhoodIndex(
            np.asarray(ld("index", mmap=False)),
            np.asarray(ld("indicator", mmap=False)))

    # ------------------------------------------------- wo-canonical mode
    def wo_canonical_samples(
        self, query_ids: Sequence[int],
        use_tconv: bool = True,
        truth: Optional[np.ndarray] = None,
        num_workers: Optional[int] = None,
    ) -> List[GraphSample]:
        """Whole-graph samples for the no-canonical-partition ablation:
        each graph becomes ONE untyped (union_node) sample labeled with
        its graph-level counts. The labels are RAW graphlet counts; the
        training path applies log2(+1) once (the reference stores
        log2(count + 1) and logs again, a double log desco_tpu does not
        reproduce, nor does the port)."""
        from ..batch.build import query_sample

        if truth is None:
            truth = self.compute_groundtruth(query_ids,
                                             num_workers=num_workers)
        graphlet = self.aggregate_node_counts(truth)
        samples = []
        for gid, g in enumerate(self.graphs):
            s = query_sample(g, use_tconv=use_tconv)
            s.y = graphlet[gid].astype(np.float32)
            samples.append(s)
        return samples

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
