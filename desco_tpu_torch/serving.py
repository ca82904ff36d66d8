"""Serving API: graphs in -> graphlet counts out, on one CUDA device.

The port of ``desco_tpu/serving.py``. ``CountingService`` loads the
checkpoints once (desco_tpu's ``.params.npz`` + ``.json``; the pipeline
config rehydrates from the JSON blob), embeds the static query set once,
and serves requests with every guard on by default: combinatorial clamp,
exact tail verification (VF2 recount of the top predicted tail), gossip
refinement with verified-row override, node clamp. Packing capacities
are bucketed by pow2 graph-slot count and pin monotonically, as in
desco_tpu, so both packages cut a request into the same batches.

The service runs on CUDA unless the caller passes ``device="cpu"``; with
no GPU visible it raises rather than fall back. Float32 throughout, with
TF32 off (utils/device.py). Not in this slice (ROADMAP.md, Queue 1):
``count_large_graph`` (halo-sharded gossip, M16) and ``n_devices > 1``
(data-parallel serving, M15).

Typical use::

    svc = CountingService("release/r4/neigh.best", "release/r4/gossip.best")
    res = svc.count(graphs)           # -> CountResult
    res.graphlet_counts               # [n_graphs, n_queries]
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from .graph import Graph
from .models import neighborhood as neigh_mod
from .pipeline import (
    PipelineConfig,
    apply_exact_column_override,
    apply_verified_override,
    build_query_batch,
    clamp_node_counts,
    exact_columns,
    model_configs,
    neighborhood_predictions,
    pipeline_queries,
    prepare_gossip_batches,
    prepare_stage_data,
)
from .train.checkpoint import load_checkpoint
from .train.loop import predict_gossip_counts
from .utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CountResult:
    """Counts for one ``CountingService.count`` request.

    graphlet_counts: [n_graphs, n_queries] rounded non-negative counts
        (gossip-refined when the service has a gossip model).
    node_counts: [total_nodes, n_queries] per-node canonical counts in
        input node order (graphs concatenated); zero rows for nodes
        whose canonical neighborhood is edgeless.
    neighborhood_counts: [n_neighborhoods, n_queries] raw stage-1
        output after clamp + verification.
    verified_rows: neighborhood row indices recounted EXACTLY by VF2.
    refined: whether gossip refinement ran.
    """

    graphlet_counts: np.ndarray
    node_counts: np.ndarray
    neighborhood_counts: np.ndarray
    verified_rows: np.ndarray
    refined: bool


def _rehydrate_config(meta: dict,
                      overrides: Optional[dict]) -> PipelineConfig:
    fields = {f.name for f in dataclasses.fields(PipelineConfig)}
    raw = {k: v for k, v in (meta.get("config") or {}).items()
           if k in fields}
    if "query_sizes" in raw:
        raw["query_sizes"] = tuple(raw["query_sizes"])
    raw.update(overrides or {})
    return PipelineConfig(**raw)


class CountingService:
    """Load-once, count-forever serving front end (see module docs)."""

    def __init__(
        self,
        neigh_checkpoint: str,
        gossip_checkpoint: Optional[str] = None,
        config_overrides: Optional[dict] = None,
        n_devices: int = 1,
        device=None,
    ) -> None:
        """``device``: None or "cuda" serve on the GPU (and raise when
        none is visible); "cpu" serves on the CPU, as the tests do."""
        if n_devices != 1:
            raise NotImplementedError(
                "data-parallel serving (n_devices != 1) is not ported yet "
                "(ROADMAP.md, Queue 1 M15)")
        self.device = resolve_device(device)
        self.neigh_params, meta = self._load(neigh_checkpoint)
        self.cfg = cfg = _rehydrate_config(meta, config_overrides)
        self.tgt_cfg, self.qry_cfg = model_configs(cfg, self.device)
        self.query_batch = build_query_batch(cfg)
        # static query set -> embed once, reuse every request (the count
        # head and the gossip model both read these embeddings)
        with torch.inference_mode():
            self.query_embs = neigh_mod.embed_queries(
                self.neigh_params, self.qry_cfg,
                self.query_batch.to(self.device))
        self.gossip_params = None
        if gossip_checkpoint is not None:
            self.gossip_params, _ = self._load(gossip_checkpoint)
        # capacity buckets keyed by pow2 graph-slot count; each bucket's
        # (n_cap, e_cap) grows monotonically. count_stream's producer
        # thread and count() both reach _pin_caps, so growth is locked.
        self._neigh_buckets: dict = {}
        self._gossip_buckets: dict = {}
        self._caps_lock = threading.Lock()

    def _load(self, path: str):
        params, meta = load_checkpoint(path)
        return params.requires_grad_(False).to(self.device), meta

    # ------------------------------------------------------ capacities
    @staticmethod
    def _fit(caps: Optional[tuple], samples) -> bool:
        if caps is None:
            return False
        n_cap, e_cap, _ = caps
        # pack_samples accepts n_nodes <= n_cap - 1 (one pad slot)
        return all(s.n_nodes + 1 <= n_cap and s.n_edges <= e_cap
                   for s in samples)

    @staticmethod
    def _grow(caps: Optional[tuple], fresh: tuple) -> tuple:
        if caps is None:
            return fresh
        return tuple(max(a, b) for a, b in zip(caps, fresh))

    def _pin_caps(self, buckets: dict, samples, g_cap_max: int) -> tuple:
        """Bucketed, monotone-growing pinned capacities."""
        from .batch.packed import auto_capacities

        if not samples:  # edgeless/empty request: caller short-circuits
            return (128, 512, 1)
        g_target = 1
        while g_target < min(len(samples), g_cap_max):
            g_target *= 2
        g_target = min(g_target, g_cap_max)
        with self._caps_lock:
            caps = buckets.get(g_target)
            if not self._fit(caps, samples):
                caps = self._grow(caps,
                                  auto_capacities(samples, g_cap=g_target,
                                                  slack=1.2))
                # keep the slot count at the bucket key (auto_capacities
                # shrinks g_cap to len(samples)) so repeats share shapes
                caps = (caps[0], caps[1], g_target)
                buckets[g_target] = caps
            return caps

    def _select_neigh_caps(self, samples) -> tuple:
        return self._pin_caps(self._neigh_buckets, samples,
                              self.cfg.neigh_batch_size)

    # ---------------------------------------------------------- counting
    def _check_refine(self, refine: Optional[bool]) -> bool:
        if refine is None:
            refine = self.gossip_params is not None
        if refine and self.gossip_params is None:
            raise ValueError("refine=True but no gossip checkpoint loaded")
        return refine

    def count(self, graphs: Sequence[Graph],
              refine: Optional[bool] = None) -> CountResult:
        """Count all configured queries in each input graph.

        refine: run gossip refinement; default = whenever the service
        has a gossip model. Exact-verified rows always override the
        learned residual (pipeline.apply_verified_override)."""
        refine = self._check_refine(refine)
        stage = prepare_stage_data(self.cfg, list(graphs),
                                   capacities=self._select_neigh_caps)
        return self._finish_request(stage, refine)

    def count_graph(self, graph: Graph, **kw) -> np.ndarray:
        """[n_queries] counts for a single graph."""
        return self.count([graph], **kw).graphlet_counts[0]

    def count_large_graph(self, graph: Graph, n_devices: int = 0,
                          refine: Optional[bool] = None) -> CountResult:
        raise NotImplementedError(
            "single-large-graph serving (halo-sharded gossip) is not "
            "ported yet (ROADMAP.md, Queue 1 M16, and kernel K4)")

    def _empty_result(self, stage) -> CountResult:
        """All-zero counts: every canonical neighborhood is edgeless
        (or the request had no graphs)."""
        n_q = len(pipeline_queries(self.cfg))
        return CountResult(
            graphlet_counts=np.zeros((len(stage.workload.graphs), n_q)),
            node_counts=np.zeros((stage.workload.total_nodes, n_q)),
            neighborhood_counts=np.zeros((0, n_q)),
            verified_rows=np.zeros(0, np.int64),
            refined=False,
        )

    def _finish_request(self, stage, refine: bool) -> CountResult:
        """Device stages + guards for one prepared request."""
        if not stage.samples:
            return self._empty_result(stage)
        counts, verified = neighborhood_predictions(
            self.neigh_params, self.tgt_cfg, self.query_embs, stage,
            self.cfg, self.device)
        if not refine:
            return self._package_unrefined(stage, counts, verified)
        gb = prepare_gossip_batches(
            self.cfg, stage, counts,
            capacities=lambda samples: self._pin_caps(
                self._gossip_buckets, samples, self.cfg.gossip_batch_size))
        node_counts = predict_gossip_counts(
            self.gossip_params, self.query_embs, gb, self.device)
        return self._guard_and_package(stage, node_counts, counts, verified)

    def _guard_and_package(self, stage, node_counts, counts,
                           verified) -> CountResult:
        """Post-refinement guard chain: combinatorial clamp ->
        exact-verified row override -> exact-small-query column
        override -> graphlet aggregation."""
        if self.cfg.clamp_counts:
            node_counts = clamp_node_counts(
                node_counts, stage, self.cfg,
                canonical_type=self.tgt_cfg.canonical_type,
                device=self.device)
        node_counts = apply_verified_override(
            node_counts, counts, verified, stage.nindex)
        if self.cfg.exact_size > 0:
            node_counts = apply_exact_column_override(
                node_counts, counts, exact_columns(self.cfg), stage.nindex)
        graphlet = stage.workload.aggregate_node_counts(node_counts)
        return CountResult(
            graphlet_counts=np.round(np.maximum(graphlet, 0.0)),
            node_counts=node_counts,
            neighborhood_counts=counts,
            verified_rows=verified,
            refined=True,
        )

    @staticmethod
    def _package_unrefined(stage, counts, verified) -> CountResult:
        node_counts = np.zeros((stage.workload.total_nodes,
                                counts.shape[1]), counts.dtype)
        rows = np.nonzero(np.asarray(stage.nindex.indicator))[0]
        node_counts[rows] = counts
        graphlet = stage.workload.aggregate_neighborhood_counts(
            counts, stage.nindex)
        return CountResult(
            graphlet_counts=np.round(np.maximum(graphlet, 0.0)),
            node_counts=node_counts,
            neighborhood_counts=counts,
            verified_rows=verified,
            refined=False,
        )

    def count_stream(self, requests, refine: Optional[bool] = None,
                     prefetch: int = 1):
        """Pipelined serving over an iterable of graph batches.

        Host work (canonical decomposition, triangle typing, packing —
        the C++ prep releases the GIL) for request k+1 overlaps device
        work for request k: a background thread runs
        ``prepare_stage_data`` up to ``prefetch`` requests ahead and
        touches no CUDA; the calling thread runs every device stage.
        Yields ``CountResult`` in request order, identical to per-request
        ``count`` calls. Abandoning the iterator early (break / close)
        stops and joins the producer."""
        refine = self._check_refine(refine)
        return self._stream(requests, refine, prefetch)

    def _stream(self, requests, refine: bool, prefetch: int):
        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for graphs in requests:
                    if stop.is_set():
                        return
                    stage = prepare_stage_data(
                        self.cfg, list(graphs),
                        capacities=self._select_neigh_caps)
                    if not put(stage):
                        return
            except BaseException as e:  # re-raised in the consumer
                put(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield self._finish_request(item, refine)
        finally:
            # consumer gone (break/close/exception): unblock + reap the
            # producer so no thread or prepared StageData lingers
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10)
