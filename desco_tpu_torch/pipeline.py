"""End-to-end DeSCo pipeline — the port of ``desco_tpu/pipeline.py``, the
library-level orchestration under serving (serving.py) and the training
CLI (main.py).

A request runs: canonical partition -> packed neighborhood batches ->
SHMP neighborhood counts (clamped to the combinatorial bounds, the top
tail recounted exactly by VF2) -> gossip refinement over the original
graphs -> node clamp and exact-row overrides -> graph-level counts.
Training adds exact ground truth (C++ VF2, cached on disk), the two
training stages and the normed-MSE / MAE evaluation per query size.

``serve_bf16`` and ``train_bf16`` run the target tower in bfloat16
(f32 master parameters, f32 count head, f32 accumulation in every
segment reduction); everything past the count head stays f32.

Every conv type (``conv_type``), order-4 typing (``order=4``) and the
homogeneous ablation (``use_hetero=False``) run through the same
functions. Labeled mode (``use_node_feature``) expands each query into
all its one-hot label assignments (``neigh_input_dim`` labels), feeds
the graphs' one-hot ``node_feat`` to the target tower, and counts, bounds
and verifies under label-preserving matching. A list of neighborhood
models (a checkpoint ensemble) averages their stage-1 predictions in
log2(count + 1) space. A ``mesh`` (parallel/dp.make_mesh) trains both
stages data-parallel and shards the stage-1 forward over its replicas,
bit-equal to one device. The stage-1 forward and the bounds replay
compiled forwards (utils/cuda_graphs.py; ``graphed=False`` runs them eagerly),
from a service's ``ServingGraphs`` where one is given, else from caches
made for the call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .analysis import mae, norm_mse, round_relu
from .batch.build import query_sample
from .batch.packed import GraphSample, PackedGraphs, auto_capacities, pack_samples
from .data.workload import NeighborhoodIndex, Workload
from .graph.atlas import expand_query_labels, gen_queries, gen_query_ids
from .graph.container import Graph
from .models import gossip as gossip_mod
from .models import neighborhood as neigh_mod
from .models.shmp_gnn import neighborhood_target_config, query_config
from .parallel import dp
from .train import loop as train_loop
from .utils import trace
from .utils.device import resolve_device


@dataclasses.dataclass
class PipelineConfig:
    """desco_tpu's PipelineConfig, with its names and defaults (the
    paper config). Checkpoint config blobs rehydrate into it."""

    query_sizes: Sequence[int] = (3, 4, 5)
    depth: int = 4
    use_hetero: bool = True
    use_tconv: bool = True
    order: int = 3
    conv_type: str = "SAGE"
    # neighborhood stage
    neigh_layer_num: int = 8
    neigh_hidden_dim: int = 64
    neigh_input_dim: int = 1
    neigh_dropout: float = 0.0
    neigh_epochs: int = 300
    neigh_batch_size: int = 512
    neigh_lr: float = 1e-4
    neigh_weight_decay: float = 0.0
    # gossip stage
    gossip_layer_num: int = 2
    gossip_hidden_dim: int = 64
    gossip_dropout: float = 0.01
    gossip_epochs: int = 30
    gossip_batch_size: int = 256
    gossip_lr: float = 1e-3
    gossip_weight_decay: float = 0.0
    # target-tower aggregation: 'auto' (and desco_tpu's 'pallas') pick
    # the fused CUDA kernel on a CUDA device and 'aggregate_first' on the
    # CPU; desco_tpu's XLA transform-then-reduce modes ('transform_first',
    # 'cumsum') compute what the kernel computes and map to it
    agg_mode: str = "auto"
    # bfloat16 target tower at serving time (the count head stays f32)
    serve_bf16: bool = False
    # bfloat16 target tower in the train step: f32 master parameters,
    # f32 gradients, validation and checkpoints on the f32 tower
    train_bf16: bool = False
    # run the val pass every k epochs instead of every epoch (the
    # plateau scheduler and best-checkpoint selection then see one
    # monitored value per k epochs). 1 = every epoch
    val_every: int = 1
    # log2(1+degree) as the node input feature of both towers
    degree_feature: bool = False
    # clamp de-logged stage-1 counts to the combinatorial bound
    clamp_counts: bool = True
    # per query, the ceil(budget*N) neighborhoods with the largest
    # predicted counts are recounted EXACTLY with VF2. 0 disables.
    verify_budget: float = 1e-3
    # exact-count every query with <= this many nodes. 0 disables.
    exact_size: int = 0
    use_node_feature: bool = False
    custom_query_ids: Optional[Sequence[int]] = None
    # misc
    seed: int = 0
    data_root: str = "data"
    output_dir: Optional[str] = None
    # host threads for sample prep and VF2 (None: all cores)
    num_workers: Optional[int] = None

    @property
    def query_ids(self) -> List[int]:
        if self.custom_query_ids is not None:
            return list(self.custom_query_ids)
        return gen_query_ids(list(self.query_sizes))


def check_serving_config(cfg: PipelineConfig) -> None:
    """Raise for the feature combinations desco_tpu refuses: the degree
    feature writes x[:, 0], which would overwrite the homogeneous
    samples' canonical indicator or the first label column."""
    if cfg.degree_feature and not cfg.use_hetero:
        raise ValueError(
            "degree_feature requires use_hetero (homogeneous samples "
            "carry the canonical indicator in x)")
    if cfg.degree_feature and cfg.use_node_feature:
        raise ValueError(
            "degree_feature and use_node_feature are mutually exclusive "
            "(the degree write clobbers label column 0)")


_QUERY_MEMO: dict = {}


def pipeline_queries(cfg: PipelineConfig) -> List[Graph]:
    """The query set: the atlas queries, each expanded into its one-hot
    label assignments in labeled mode (memoized: serving consults it
    several times per request; queries are immutable host Graphs)."""
    key = (tuple(cfg.query_ids), cfg.use_node_feature, cfg.neigh_input_dim)
    hit = _QUERY_MEMO.get(key)
    if hit is None:
        hit = gen_queries(cfg.query_ids)
        if cfg.use_node_feature:
            hit = [v for q in hit
                   for v in expand_query_labels(q, cfg.neigh_input_dim)]
        _QUERY_MEMO[key] = hit
    return hit


def pipeline_query_groups(cfg: PipelineConfig) -> List[List[int]]:
    """Query indices grouped by query size, ascending (the per-size
    normed-MSE grouping), over the expanded set in labeled mode."""
    queries = pipeline_queries(cfg)
    sizes = sorted({q.n_nodes for q in queries})
    return [[i for i, q in enumerate(queries) if q.n_nodes == s]
            for s in sizes]


def model_configs(cfg: PipelineConfig, device):
    """(target, query) SHMP configs; the target tower's agg_mode resolves
    for ``device`` (ops/cuda_segment.default_agg_mode)."""
    from .ops.cuda_segment import default_agg_mode

    check_serving_config(cfg)
    agg = cfg.agg_mode
    if agg in ("auto", "pallas"):
        agg = default_agg_mode(device)
    elif agg in ("transform_first", "cumsum"):
        agg = "kernel"
    tgt = neighborhood_target_config(
        use_tconv=cfg.use_tconv, use_hetero=cfg.use_hetero,
        order=cfg.order,
        input_dim=cfg.neigh_input_dim, hidden_dim=cfg.neigh_hidden_dim,
        output_dim=cfg.neigh_hidden_dim, layer_num=cfg.neigh_layer_num,
        conv_type=cfg.conv_type, dropout=cfg.neigh_dropout, agg_mode=agg)
    qry = query_config(
        use_tconv=cfg.use_tconv,
        input_dim=cfg.neigh_input_dim, hidden_dim=cfg.neigh_hidden_dim,
        output_dim=cfg.neigh_hidden_dim, layer_num=cfg.neigh_layer_num,
        conv_type=cfg.conv_type, dropout=cfg.neigh_dropout)
    return tgt, qry


def apply_degree_feature(samples) -> None:
    """x[:, 0] = log2(1 + degree) in place (cfg.degree_feature), the
    degree counted within the sample on the directed edge stream."""
    for s in samples:
        deg = np.bincount(s.edge_src, minlength=len(s.node_type))
        degf = np.log2(1.0 + deg).astype(np.float32)
        if s.x is not None and s.x.ndim == 2 and s.x.shape[1] > 1:
            s.x = s.x.copy()
            s.x[:, 0] = degf
        else:
            s.x = degf[:, None]


def build_query_batch(cfg: PipelineConfig) -> PackedGraphs:
    queries = pipeline_queries(cfg)
    qs = [query_sample(q, use_tconv=cfg.use_tconv,
                       f_dim=cfg.neigh_input_dim) for q in queries]
    if cfg.degree_feature:
        apply_degree_feature(qs)
    batches = pack_samples(qs, *auto_capacities(qs, g_cap=len(qs)))
    if len(batches) != 1:
        raise RuntimeError("query set must pack into one batch")
    return batches[0]


@dataclasses.dataclass
class StageData:
    """One request's, or one dataset split's, prepared data for the
    neighborhood stage."""

    workload: Workload
    samples: List[GraphSample]
    nindex: NeighborhoodIndex
    truth: np.ndarray  # (total_nodes, Q) float64; zeros without labels
    batches: List[PackedGraphs]


def prepare_stage_data(cfg: PipelineConfig, graphs: List[Graph],
                       capacities=None, *, name: Optional[str] = None,
                       need_truth: bool = False) -> StageData:
    """Host work of one request or split: canonical partition, sample
    typing and packing. ``capacities`` is (n_cap, e_cap, g_cap) or a
    callable that picks them from the samples (the serving buckets). No
    device work.

    ``need_truth=True`` (training and evaluation) computes the exact VF2
    ground truth, cached under ``cfg.data_root/name`` beside the
    neighborhood sample cache, attaches it as labels and packs the
    backward edge permutation; the default (pure
    serving: no labels exist and none are needed) leaves the label
    columns zero and skips the permutation's host lexsort. In labeled
    mode the truth is the label-preserving one over the expanded query
    set and the samples carry the graphs' one-hot ``node_feat``."""
    check_serving_config(cfg)
    if need_truth and name is None:
        raise ValueError("need_truth=True wants the dataset's name (its "
                         "truth cache lives under cfg.data_root/name)")
    wl = Workload(graphs,
                  root=os.path.join(cfg.data_root, name) if name else None,
                  name=name or "request")
    if not need_truth:
        truth = np.zeros((wl.total_nodes, len(pipeline_queries(cfg))),
                         np.float64)
    elif cfg.use_node_feature:
        truth = wl.compute_groundtruth_labeled(pipeline_queries(cfg),
                                               num_workers=cfg.num_workers)
    else:
        truth = wl.compute_groundtruth(cfg.query_ids,
                                       num_workers=cfg.num_workers)
    # the sample cache under the dataset's root only where truth is
    # computed: a serving request sees its graphs once
    with trace.span("prepare.decompose"):
        samples, nindex = wl.neighborhood_samples(
            cfg.depth, use_tconv=cfg.use_tconv, truth=truth,
            num_workers=cfg.num_workers, order=cfg.order,
            use_cache=need_truth, use_hetero=cfg.use_hetero,
            use_node_feat=cfg.use_node_feature)
    if cfg.degree_feature:
        apply_degree_feature(samples)
    if callable(capacities):
        capacities = capacities(samples)
    if not samples:
        return StageData(wl, samples, nindex, truth, [])
    caps = capacities or auto_capacities(samples, g_cap=cfg.neigh_batch_size)
    # the backward edge permutation only matters for training
    with trace.span("prepare.pack"):
        batches = pack_samples(samples, *caps, n_queries=truth.shape[1],
                               need_bwd_perm=need_truth)
    return StageData(wl, samples, nindex, truth, batches)


def train_neighborhood_stage(
    cfg: PipelineConfig, train: StageData, val: StageData,
    query_batch: PackedGraphs, ckpt_path: Optional[str] = None,
    log_fn=print, resume: bool = False, mesh=None, device=None, **kw,
):
    """Train the neighborhood model on ``train`` with ``val`` monitored.
    Returns (TrainResult, tgt_cfg, qry_cfg). ``device``: None or "cuda"
    train on the GPU (and raise when none is visible), "cpu" on the CPU.
    Fresh weights come from ``cfg.seed``. A ``mesh`` trains data-parallel
    over its replicas (parallel/dp.py).

    ``cfg.train_bf16`` puts the bf16 cast into the tower config of the
    train step only: the parameters are the f32 masters throughout, the
    val passes run the f32 tower (so plateau and best-checkpoint decisions
    match the serving forward), checkpoints are f32, and the returned
    ``tgt_cfg`` is f32."""
    device = resolve_device(device)
    tgt_cfg, qry_cfg = model_configs(cfg, device)
    params = neigh_mod.init_neighborhood_model(
        tgt_cfg, qry_cfg, torch.Generator().manual_seed(cfg.seed))
    tgt_train = (dataclasses.replace(tgt_cfg, dtype=torch.bfloat16)
                 if cfg.train_bf16 else tgt_cfg)
    result = train_loop.train_neighborhood(
        params, tgt_train, qry_cfg, query_batch,
        train.batches, val.batches,
        epochs=cfg.neigh_epochs, lr=cfg.neigh_lr,
        weight_decay=cfg.neigh_weight_decay,
        ckpt_path=ckpt_path, ckpt_config=dataclasses.asdict(cfg),
        seed=cfg.seed, log_fn=log_fn, resume=resume, mesh=mesh,
        val_every=cfg.val_every, eval_tgt_cfg=tgt_cfg, device=device, **kw)
    return result, tgt_cfg, qry_cfg


def neighborhood_predictions(params, tgt_cfg, query_embs,
                             stage: StageData, cfg: PipelineConfig, device,
                             mesh=None, graphed: bool = True, graphs=None):
    """(counts, verified): (#neighborhoods, Q) de-logged stage-1 counts,
    clamped to the combinatorial neighborhood bound when cfg.clamp_counts
    and exact-recounted on the top tail when cfg.verify_budget > 0, and
    the neighborhood row indices whose counts are now EXACT. With
    ``cfg.serve_bf16`` the target tower runs in bfloat16; the count head
    and everything after it stay f32.

    A list of models with the list of their query embeddings is a
    checkpoint ensemble: the members' predictions are averaged in the
    model's log2(count + 1) space (count errors are multiplicative), then
    de-logged; clamp and verification run once on the mean. The batches
    go to the device once and every member reads them. A one-member list
    is the single path. The forward runs over ``mesh`` (default: one
    replica on ``device``), batch i on replica i % D (parallel/dp.py), bit
    for bit what one device gives.

    ``graphed``: the forward and the bounds replay compiled forwards, from
    ``graphs`` (a service's ``utils/cuda_graphs.ServingGraphs``: one cache per
    member, one for the bounds, all under its lock, which is held over
    these device stages) or from caches made for this call."""

    if cfg.serve_bf16:
        tgt_cfg = dataclasses.replace(tgt_cfg, dtype=torch.bfloat16)
    members = list(params) if isinstance(params, (list, tuple)) else [params]
    embs = (list(query_embs) if isinstance(query_embs, (list, tuple))
            else [query_embs])
    if len(members) != len(embs):
        raise ValueError(f"{len(members)} ensemble members but "
                         f"{len(embs)} query embeddings")
    mesh = mesh or dp.make_mesh(1, device)
    device_stage = (trace.lock(graphs.lock, "device_lock.wait")
                    if graphs is not None else contextlib.nullcontext())
    caches = (graphs.members if graphs is not None
              else [None] * len(members))
    with device_stage:
        staged = None
        if len(members) > 1:
            # the members share one copy of the batches on the card
            with trace.span("stage1.stage"):
                staged = dp.stage_batches_for_dp(stage.batches, mesh)

        def forward(p, e, cache):
            return dp.dp_predict_neighborhood_counts(
                p, tgt_cfg, e, stage.batches, mesh, staged=staged,
                graphed=graphed, cache=cache)
        if len(members) == 1:
            counts = forward(members[0], embs[0], caches[0])
        else:
            logs = np.mean([np.log2(np.maximum(forward(p, e, c), 0.0) + 1.0)
                            for p, e, c in zip(members, embs, caches)],
                           axis=0)
            counts = np.exp2(logs) - 1.0
    verified = np.zeros(0, np.int64)
    if cfg.clamp_counts:
        from .truth.bounds import clamp_counts

        with device_stage:
            ubs = stage_bounds(stage, cfg,
                               canonical_type=tgt_cfg.canonical_type,
                               device=device, graphed=graphed,
                               cache=(graphs.bounds if graphs is not None
                                      else None))
        counts = clamp_counts(counts, ubs)
    if cfg.exact_size > 0:
        # exact small-query columns BEFORE the tail ranking, so the
        # verifier's per-column top-k sees exact values there
        counts, _ = exact_small_counts(counts, stage, cfg)
    if cfg.verify_budget > 0:
        with trace.span("verify"):
            counts, verified = verify_tail_counts(counts, stage, cfg)
    return counts, verified


def verify_tail_counts(counts: np.ndarray, stage: StageData,
                       cfg: PipelineConfig):
    """Exact-recount the top predicted tail: per QUERY COLUMN, the
    ceil(verify_budget * N) neighborhoods with the largest predicted
    count — unioned across columns and with the top-k by row total — are
    replaced by exact canonical counts from the thread-pooled native VF2
    run on their own (<= depth-d) neighborhood subgraphs. Uses only the
    input graph; labeled mode recounts under label matching. Returns
    (counts copy, verified row indices)."""
    queries = pipeline_queries(cfg)
    n = counts.shape[0]
    k = max(1, int(np.ceil(cfg.verify_budget * n)))
    by_total = np.argsort(-counts.sum(axis=1))[:k]
    by_col = np.argpartition(-counts, min(k, n - 1), axis=0)[:k]
    flagged = np.unique(np.concatenate([by_total, by_col.ravel()]))

    from .graph.canonical import canonical_neighborhood

    counts = counts.copy()
    index = np.asarray(stage.nindex.index)
    nbs, rows = [], []
    for i in flagged:
        gid, vid = int(index[i, 0]), int(index[i, 1])
        nb = canonical_neighborhood(stage.workload.graphs[gid], vid,
                                    cfg.depth)
        if nb is not None:
            nbs.append(nb)
            rows.append(i)
    row_arr = np.asarray(rows, np.int64)
    if not nbs:
        return counts, row_arr
    per_nb = _canonical_counts(cfg)(
        [nb.graph for nb in nbs], queries, cfg.num_workers)
    for nb, i, cc in zip(nbs, rows, per_nb):
        counts[i] = cc[nb.canonical]
    return counts, row_arr


def _canonical_counts(cfg: PipelineConfig):
    """The exact per-node counter of ``cfg``'s mode: label-preserving VF2
    in labeled mode, plain VF2 otherwise (both thread-parallel)."""
    from .truth import native as truth_native

    return (truth_native.parallel_labeled_counts if cfg.use_node_feature
            else truth_native.parallel_canonical_counts)


def exact_columns(cfg: PipelineConfig) -> np.ndarray:
    """Query columns served exactly under cfg.exact_size."""
    if cfg.exact_size <= 0:
        return np.zeros(0, np.int64)
    return np.asarray([i for i, q in enumerate(pipeline_queries(cfg))
                       if q.n_nodes <= cfg.exact_size], np.int64)


def exact_small_counts(counts: np.ndarray, stage: StageData,
                       cfg: PipelineConfig):
    """Serve every query with <= cfg.exact_size nodes EXACTLY: recount
    those columns for ALL neighborhoods with VF2 on the neighborhood
    subgraphs rebuilt from the staged samples. Returns (counts copy,
    column indices now exact)."""
    queries = pipeline_queries(cfg)
    qcols = exact_columns(cfg)
    if not len(qcols):
        return counts, np.zeros(0, np.int64)
    sub_queries = [queries[i] for i in qcols]

    from .batch.build import CANONICAL

    graphs, canon = [], []
    for s in stage.samples:
        # each undirected edge is listed in both orientations
        und = s.edge_src < s.edge_dst
        edges = np.stack(
            [s.edge_src[und], s.edge_dst[und]], 1).astype(np.int32)
        graphs.append(Graph(s.n_nodes, edges,
                            s.x if cfg.use_node_feature else None))
        canon.append(int(np.argmax(s.node_type == CANONICAL)))
    counts = counts.copy()
    per_nb = _canonical_counts(cfg)(graphs, sub_queries, cfg.num_workers)
    for r, (cc, cv) in enumerate(zip(per_nb, canon)):
        counts[r, qcols] = cc[cv]
    return counts, qcols


def apply_exact_column_override(gossip_node_counts: np.ndarray,
                                neigh_counts: np.ndarray,
                                exact_cols: np.ndarray,
                                nindex) -> np.ndarray:
    """Keep exactly-counted query columns exact through the gossip stage:
    write the stage-1 value back at every neighborhood's canonical node
    row. Returns a copy."""
    out = np.array(gossip_node_counts)
    if len(exact_cols):
        node_rows = np.nonzero(np.asarray(nindex.indicator))[0]
        out[np.ix_(node_rows, np.asarray(exact_cols))] = (
            neigh_counts[:, np.asarray(exact_cols)])
    return out


def stage_bounds(stage: StageData, cfg: PipelineConfig,
                 canonical_type: int = 1, *, device, graphed: bool = True,
                 cache=None) -> np.ndarray:
    """(#neighborhoods, Q) combinatorial upper bounds of a request,
    computed once and memoized on the StageData (the stage-1 clamp and
    the stage-3 node clamp use the same bounds); ``graphed`` and ``cache``
    as in ``truth/bounds.neighborhood_count_bounds``."""
    key = (canonical_type, cfg.use_node_feature, tuple(cfg.query_ids),
           cfg.neigh_input_dim)
    memo = getattr(stage, "_bounds_cache", None)
    if memo is None or memo[0] != key:
        from .truth.bounds import neighborhood_count_bounds

        # labeled mode divides by the label-preserving |Aut|
        cached = neighborhood_count_bounds(
            stage.batches, pipeline_queries(cfg),
            canonical_type=canonical_type, labeled=cfg.use_node_feature,
            device=device, graphed=graphed, cache=cache)
        object.__setattr__(stage, "_bounds_cache", (key, cached))
        return cached
    return memo[1]


def clamp_node_counts(node_counts: np.ndarray, stage: StageData,
                      cfg: PipelineConfig, canonical_type: int = 1,
                      *, device, graphed: bool = True,
                      cache=None) -> np.ndarray:
    """Clamp per-node (canonical) counts — the gossip-refined stage-3
    output — to [0, UB(v)], UB(v) the bound of v's canonical
    neighborhood; nodes whose neighborhood was dropped as edgeless get
    exactly 0 (the bounds as ``stage_bounds`` gives them). Returns a
    copy."""
    ubs = stage_bounds(stage, cfg, canonical_type=canonical_type,
                       device=device, graphed=graphed, cache=cache)
    out = np.zeros_like(node_counts)
    node_rows = np.nonzero(np.asarray(stage.nindex.indicator))[0]
    out[node_rows] = np.clip(node_counts[node_rows], 0.0,
                             ubs.astype(node_counts.dtype))
    return out


def apply_verified_override(gossip_node_counts: np.ndarray,
                            neigh_counts: np.ndarray,
                            verified_rows: np.ndarray,
                            nindex) -> np.ndarray:
    """Exact counts beat any learned residual: where the verifier
    recounted a neighborhood, keep that value through the gossip stage
    (its node row is the i-th True of the indicator). Returns a copy."""
    out = np.array(gossip_node_counts)
    if len(verified_rows):
        node_rows = np.nonzero(np.asarray(nindex.indicator))[0][
            np.asarray(verified_rows)]
        out[node_rows] = neigh_counts[verified_rows]
    return out


def prepare_gossip_batches(
    cfg: PipelineConfig, stage: StageData, neigh_counts: np.ndarray,
    capacities=None, need_bwd_perm: bool = False,
) -> List[PackedGraphs]:
    """Packed gossip batches over the original graphs (the span
    ``gossip.pack``). Serving leaves ``need_bwd_perm`` off: the backward
    permutation is training-only and costs a full-row host lexsort per
    batch."""
    with trace.span("gossip.pack"):
        samples = stage.workload.gossip_samples(neigh_counts, stage.nindex,
                                                stage.truth)
        if callable(capacities):  # serving bucket selection sees them
            capacities = capacities(samples)
        caps = capacities or auto_capacities(samples,
                                             g_cap=cfg.gossip_batch_size)
        return pack_samples(samples, *caps, n_queries=stage.truth.shape[1],
                            need_bwd_perm=need_bwd_perm)


def train_gossip_stage(
    cfg: PipelineConfig, params_neigh, tgt_cfg, qry_cfg,
    query_batch: PackedGraphs, train_batches, val_batches,
    ckpt_path: Optional[str] = None, log_fn=print, resume: bool = False,
    mesh=None, device=None, **kw,
):
    """Train the gossip model against the (fixed) query embeddings of the
    trained neighborhood model. Returns (TrainResult, query_embs on the
    device). Fresh weights come from ``cfg.seed + 1``. A ``mesh`` trains
    data-parallel (parallel/dp.py)."""
    device = resolve_device(device)
    with torch.no_grad():
        query_embs = neigh_mod.embed_queries(
            params_neigh.to(device), qry_cfg, query_batch.to(device))
    params = gossip_mod.init_gossip_model(
        input_dim=1, hidden_dim=cfg.gossip_hidden_dim,
        emb_channels=cfg.neigh_hidden_dim, layer_num=cfg.gossip_layer_num,
        generator=torch.Generator().manual_seed(cfg.seed + 1))
    result = train_loop.train_gossip(
        params, query_embs, train_batches, val_batches,
        epochs=cfg.gossip_epochs, lr=cfg.gossip_lr,
        weight_decay=cfg.gossip_weight_decay, dropout=cfg.gossip_dropout,
        ckpt_path=ckpt_path, ckpt_config=dataclasses.asdict(cfg),
        seed=cfg.seed, log_fn=log_fn, resume=resume, mesh=mesh,
        val_every=cfg.val_every, device=device, **kw)
    return result, query_embs


def evaluate_graphlet_counts(
    cfg: PipelineConfig, stage: StageData, neigh_counts: np.ndarray,
    gossip_node_counts: Optional[np.ndarray] = None,
) -> Dict[str, List[float]]:
    """Graph-level normed MSE / MAE per query-size group, of the stage-1
    counts and, when given, of the gossip-refined counts."""
    groups = pipeline_query_groups(cfg)
    truth_graphlet = stage.workload.aggregate_node_counts(stage.truth)
    out: Dict[str, List[float]] = {}
    pred_neigh = round_relu(stage.workload.aggregate_neighborhood_counts(
        neigh_counts, stage.nindex))
    out["norm_mse_neighborhood"] = norm_mse(pred_neigh, truth_graphlet,
                                            groups)
    out["mae_neighborhood"] = mae(pred_neigh, truth_graphlet, groups)
    if gossip_node_counts is not None:
        pred_gossip = round_relu(
            stage.workload.aggregate_node_counts(gossip_node_counts))
        out["norm_mse_gossip"] = norm_mse(pred_gossip, truth_graphlet,
                                          groups)
        out["mae_gossip"] = mae(pred_gossip, truth_graphlet, groups)
    return out
