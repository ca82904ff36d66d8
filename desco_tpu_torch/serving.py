"""Serving API: graphs in -> graphlet counts out, on CUDA.

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
TF32 off (utils/device.py), unless ``config_overrides={"serve_bf16":
True}`` asks for the bfloat16 target tower (f32 parameters cast in the
forward, f32 count head, f32 gossip). A sequence of neighborhood
checkpoints serves their ensemble (stage-1 predictions averaged in
log2(count + 1) space; the config rehydrates from the first member and
the gossip stage reads the first member's query embeddings). A
checkpoint trained in labeled mode (``use_node_feature``) serves graphs
that carry one-hot ``node_feat``. ``count_large_graph`` serves one large
graph: stage 1 as ``count`` does, the gossip halo-sharded
(parallel/halo.py). ``n_devices > 1`` (or -1, every visible device)
shards both device stages over that many data-parallel replicas
(parallel/dp.py), bit-equal to one device; ``compile_cache`` keeps the
built kernels in a directory a restarted service reuses
(utils/compile_cache.py).

Serving stays per process. desco_tpu trains across processes but cannot
serve there: it reads its sharded results back with ``np.asarray``, which
raises for an array that spans another process's devices (the halo serve,
desco_tpu/parallel/halo.py:1042; the DP predicts, desco_tpu/parallel/
dp.py:155 and :200). So the port's halo serve shards over this process's
own devices even inside a ``torch.distributed`` group: there every rank
serves the whole graph. A service made inside a group whose mesh spans
the ranks gathers every rank's predictions (parallel/dp.py), where
desco_tpu's would raise: a difference kept on purpose (ROADMAP.md, Queue
3).

The device stages replay compiled forwards, as desco_tpu jits them: the
service holds ``utils/cuda_graphs.ServingGraphs``, one cache per ensemble
member and one each for the bounds and the gossip forward, in one memory
pool; a forward is captured as a CUDA graph at the first request of its
bucket's shape (the pinned buckets below keep shapes stable; a grown
bucket captures anew and drops the graphs of the caps it replaced) and
replayed after that. Its lock is held over the device stages, so two
threads calling ``count`` never replay one graph's buffers at once;
``count_stream``'s producer thread touches no CUDA. ``graphed=False``
runs the forwards eagerly (for comparisons; nothing falls back to it).

Typical use::

    svc = CountingService("release/r4/neigh.best", "release/r4/gossip.best")
    res = svc.count(graphs)           # -> CountResult
    res.graphlet_counts               # [n_graphs, n_queries]
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .graph import Graph
from .models import neighborhood as neigh_mod
from .parallel.dp import dp_predict_gossip_counts, make_mesh
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
from .utils import trace
from .utils.cuda_graphs import ServingGraphs
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
        neigh_checkpoint: Union[str, Sequence[str]],
        gossip_checkpoint: Optional[str] = None,
        config_overrides: Optional[dict] = None,
        n_devices: int = 1,
        compile_cache: Optional[str] = None,
        device=None,
        graphed: bool = True,
    ) -> None:
        """``neigh_checkpoint``: a path, or a sequence of paths for an
        ensemble. ``device``: None or "cuda" serve on the GPU (and raise
        when none is visible); "cpu" serves on the CPU, as the tests do.
        ``n_devices > 1`` (-1: one per visible CUDA device, one on the
        CPU) runs every device forward over that many data-parallel
        replicas (parallel/dp.py): the same bits, D batches per group.
        ``compile_cache``: the directory the kernels are built into and
        loaded from (utils/compile_cache.py). ``graphed``: replay the
        compiled forwards (captured on a CUDA device, static buffers on the
        CPU); False runs them eagerly."""
        if compile_cache:
            from .utils.compile_cache import enable_compilation_cache

            enable_compilation_cache(compile_cache)
        self.device = resolve_device(device)
        # every device forward runs over this mesh, of one replica
        # without data parallelism
        self.mesh = make_mesh(0 if n_devices == -1 else max(n_devices, 1),
                              self.device)
        paths = ([neigh_checkpoint] if isinstance(neigh_checkpoint, str)
                 else list(neigh_checkpoint))
        members, metas = zip(*(self._load(p) for p in paths))
        self.members = list(members)
        self.cfg = cfg = _rehydrate_config(metas[0], config_overrides)
        self.tgt_cfg, self.qry_cfg = model_configs(cfg, self.device)
        self.query_batch = build_query_batch(cfg)
        # static query set -> embed once per member, reuse every request
        # (each member's count head reads its own embeddings; the gossip
        # model conditions on the first member's)
        with torch.inference_mode():
            q_dev = self.query_batch.to(self.device)
            self.member_embs = [
                neigh_mod.embed_queries(p, self.qry_cfg, q_dev)
                for p in self.members]
        self.gossip_params = None
        if gossip_checkpoint is not None:
            self.gossip_params, _ = self._load(gossip_checkpoint)
        self.graphed = graphed
        self.graphs = ServingGraphs(len(self.members)) if graphed else None
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
        rid = trace.new_request()
        with trace.span("request.prepare", request=rid):
            stage = prepare_stage_data(self.cfg, list(graphs),
                                       capacities=self._select_neigh_caps)
        with trace.span("request.serve", request=rid):
            return self._finish_request(stage, refine)

    def count_graph(self, graph: Graph, **kw) -> np.ndarray:
        """[n_queries] counts for a single graph."""
        return self.count([graph], **kw).graphlet_counts[0]

    def count_large_graph(self, graph: Graph, n_devices: int = 0,
                          refine: Optional[bool] = None,
                          stats: Optional[dict] = None) -> CountResult:
        """Single-LARGE-graph serving (P2P/Astro scale): stage 1 runs
        through the bounded canonical decomposition, as in ``count``
        (the working set is depth-d neighborhoods whatever the graph's
        size), and the gossip stage, which must see the WHOLE graph, runs
        halo-sharded over ``n_devices`` shards (0: one per visible CUDA
        device; one on the CPU), so no shard holds the whole graph
        (parallel/halo.serve_gossip_counts). The guards apply as in
        ``count``. ``stats``, a dict, gets the host seconds of stage 1
        (``stage1_s``: decomposition, forward, bounds, verification), its
        target batches (``stage1_batches``) and the gossip's
        ``serve_gossip_counts`` stats. Per process: inside a process
        group each rank shards over its own devices and serves the whole
        graph (desco_tpu cannot read a graph-sharded result back across
        processes; see the module's docstring)."""
        from .parallel.halo import serve_gossip_counts

        refine = self._check_refine(refine)
        t0 = time.perf_counter()
        stage = prepare_stage_data(self.cfg, [graph],
                                   capacities=self._select_neigh_caps)
        if not stage.samples:
            return self._empty_result(stage)
        counts, verified = self._stage1(stage)
        if stats is not None:
            stats["stage1_s"] = time.perf_counter() - t0
            stats["stage1_batches"] = len(stage.batches)
        if not refine:
            return self._package_unrefined(stage, counts, verified)
        x_all = np.zeros((graph.n_nodes, counts.shape[1]), np.float32)
        x_all[np.asarray(stage.nindex.indicator)] = counts.astype(
            np.float32)
        with self._device_stage():
            node_counts, gossip_stats = serve_gossip_counts(
                self.gossip_params, graph, x_all, self.member_embs[0],
                n_devices=n_devices, return_stats=True, device=self.device,
                graphed=self.graphed)
        if stats is not None:
            stats.update(gossip_stats)
        return self._guard_and_package(stage, node_counts, counts, verified)

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

    def _device_stage(self):
        """The lock over the device stages (none when eager); taking it
        is the span ``device_lock.wait``."""
        return (trace.lock(self.graphs.lock, "device_lock.wait")
                if self.graphs is not None else contextlib.nullcontext())

    def _stage1(self, stage):
        """(counts, verified rows) of stage 1: forward, bounds, clamp,
        verification."""
        return neighborhood_predictions(
            self.members, self.tgt_cfg, self.member_embs, stage,
            self.cfg, self.device, mesh=self.mesh, graphed=self.graphed,
            graphs=self.graphs)

    def _finish_request(self, stage, refine: bool) -> CountResult:
        """Device stages + guards for one prepared request."""
        trace.add("requests", 1)
        trace.add("graphs", len(stage.workload.graphs))
        if not stage.samples:
            return self._empty_result(stage)
        counts, verified = self._stage1(stage)
        if not refine:
            return self._package_unrefined(stage, counts, verified)
        gb = prepare_gossip_batches(
            self.cfg, stage, counts,
            capacities=lambda samples: self._pin_caps(
                self._gossip_buckets, samples, self.cfg.gossip_batch_size))
        with self._device_stage():
            node_counts = dp_predict_gossip_counts(
                self.gossip_params, self.member_embs[0], gb, self.mesh,
                graphed=self.graphed,
                cache=self.graphs.gossip if self.graphs is not None
                else None)
        return self._guard_and_package(stage, node_counts, counts, verified)

    def _guard_and_package(self, stage, node_counts, counts,
                           verified) -> CountResult:
        """Post-refinement guard chain: combinatorial clamp ->
        exact-verified row override -> exact-small-query column
        override -> graphlet aggregation (the span ``guards``)."""
        with trace.span("guards"):
            if self.cfg.clamp_counts:
                with self._device_stage():
                    node_counts = clamp_node_counts(
                        node_counts, stage, self.cfg,
                        canonical_type=self.tgt_cfg.canonical_type,
                        device=self.device, graphed=self.graphed,
                        cache=self.graphs.bounds if self.graphs is not None
                        else None)
            node_counts = apply_verified_override(
                node_counts, counts, verified, stage.nindex)
            if self.cfg.exact_size > 0:
                node_counts = apply_exact_column_override(
                    node_counts, counts, exact_columns(self.cfg),
                    stage.nindex)
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
                    rid = trace.new_request()
                    with trace.span("request.prepare", request=rid):
                        stage = prepare_stage_data(
                            self.cfg, list(graphs),
                            capacities=self._select_neigh_caps)
                    # (the request, its id, when its preparation ended)
                    if not put((stage, rid, trace.now())):
                        return
            except BaseException as e:  # re-raised in the consumer
                put(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with trace.span("stream.starved") as waited:
                    item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                stage, rid, ready = item
                if ready is not None:
                    if waited is not None:
                        waited.request = rid
                    # on the producer's lane: it began there
                    trace.record("request.wait", ready, trace.now(),
                                 request=rid, thread=t.ident)
                with trace.span("request.serve", request=rid):
                    res = self._finish_request(stage, refine)
                yield res
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
