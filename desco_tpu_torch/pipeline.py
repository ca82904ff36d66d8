"""End-to-end DeSCo pipeline — the port of ``desco_tpu/pipeline.py``, the
library-level orchestration under serving (serving.py) and the training
CLI (main.py).

A request runs: canonical partition -> packed neighborhood batches ->
SHMP neighborhood counts (clamped to the combinatorial bounds, the top
tail recounted exactly by VF2) -> gossip refinement over the original
graphs -> node clamp and exact-row overrides -> graph-level counts.
Training adds exact ground truth (C++ VF2, cached on disk), the two
training stages and the normed-MSE / MAE evaluation per query size.

Not ported yet, each raising where a config asks for it (ROADMAP.md,
Queue 1): labeled mode (``use_node_feature``), bf16 serving and training
(``serve_bf16``, ``train_bf16``), order-4 typing, the homogeneous
ablation, the other conv types, checkpoint ensembles and data-parallel
meshes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .analysis import mae, norm_mse, round_relu
from .batch.build import query_sample
from .batch.packed import GraphSample, PackedGraphs, auto_capacities, pack_samples
from .data.workload import NeighborhoodIndex, Workload
from .graph.atlas import gen_queries, gen_query_ids
from .graph.container import Graph
from .models import gossip as gossip_mod
from .models import neighborhood as neigh_mod
from .models.shmp_gnn import neighborhood_target_config, query_config
from .train import loop as train_loop
from .utils.device import resolve_device


@dataclasses.dataclass
class PipelineConfig:
    """desco_tpu's PipelineConfig, with its names and defaults (the
    paper config). Checkpoint config blobs rehydrate into it. Fields of
    options the port does not have yet are kept so that a config that
    sets them raises (check_serving_config, train_neighborhood_stage)
    instead of being run wrong."""

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
    serve_bf16: bool = False
    # bfloat16 target tower during training: not ported (M12), raises
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
    """Raise for the options this slice has not ported."""
    missing = [name for name, on in (
        ("use_node_feature (labeled mode)", cfg.use_node_feature),
        ("serve_bf16", cfg.serve_bf16),
        ("degree_feature with use_hetero=False",
         cfg.degree_feature and not cfg.use_hetero),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)}: not ported yet (ROADMAP.md, Queue 1)")


_QUERY_MEMO: dict = {}


def pipeline_queries(cfg: PipelineConfig) -> List[Graph]:
    """The query set (memoized: serving consults it several times per
    request; queries are immutable host Graphs)."""
    key = tuple(cfg.query_ids)
    hit = _QUERY_MEMO.get(key)
    if hit is None:
        hit = _QUERY_MEMO[key] = gen_queries(cfg.query_ids)
    return hit


def pipeline_query_groups(cfg: PipelineConfig) -> List[List[int]]:
    """Query indices grouped by query size, ascending (the per-size
    normed-MSE grouping)."""
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
    ground truth, cached under ``cfg.data_root/name``, attaches it as
    labels and packs the backward edge permutation; the default (pure
    serving: no labels exist and none are needed) leaves the label
    columns zero and skips the permutation's host lexsort."""
    check_serving_config(cfg)
    if need_truth and name is None:
        raise ValueError("need_truth=True wants the dataset's name (its "
                         "truth cache lives under cfg.data_root/name)")
    wl = Workload(graphs,
                  root=os.path.join(cfg.data_root, name) if name else None,
                  name=name or "request")
    if need_truth:
        truth = wl.compute_groundtruth(cfg.query_ids,
                                       num_workers=cfg.num_workers)
    else:
        truth = np.zeros((wl.total_nodes, len(cfg.query_ids)), np.float64)
    samples, nindex = wl.neighborhood_samples(
        cfg.depth, use_tconv=cfg.use_tconv, truth=truth,
        num_workers=cfg.num_workers, order=cfg.order)
    if cfg.degree_feature:
        apply_degree_feature(samples)
    if callable(capacities):
        capacities = capacities(samples)
    if not samples:
        return StageData(wl, samples, nindex, truth, [])
    caps = capacities or auto_capacities(samples, g_cap=cfg.neigh_batch_size)
    # the backward edge permutation only matters for training
    batches = pack_samples(samples, *caps, n_queries=truth.shape[1],
                           need_bwd_perm=need_truth)
    return StageData(wl, samples, nindex, truth, batches)


def _check_training_config(cfg: PipelineConfig, mesh) -> None:
    if cfg.train_bf16:
        raise NotImplementedError(
            "train_bf16 (bfloat16 target tower during training) is not "
            "ported yet (ROADMAP.md, Queue 1 M12)")
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training over a mesh is not ported yet "
            "(ROADMAP.md, Queue 1 M15)")


def train_neighborhood_stage(
    cfg: PipelineConfig, train: StageData, val: StageData,
    query_batch: PackedGraphs, ckpt_path: Optional[str] = None,
    log_fn=print, resume: bool = False, mesh=None, device=None, **kw,
):
    """Train the neighborhood model on ``train`` with ``val`` monitored.
    Returns (TrainResult, tgt_cfg, qry_cfg). ``device``: None or "cuda"
    train on the GPU (and raise when none is visible), "cpu" on the CPU.
    Fresh weights come from ``cfg.seed``."""
    _check_training_config(cfg, mesh)
    device = resolve_device(device)
    tgt_cfg, qry_cfg = model_configs(cfg, device)
    params = neigh_mod.init_neighborhood_model(
        tgt_cfg, qry_cfg, torch.Generator().manual_seed(cfg.seed))
    result = train_loop.train_neighborhood(
        params, tgt_cfg, qry_cfg, query_batch,
        train.batches, val.batches,
        epochs=cfg.neigh_epochs, lr=cfg.neigh_lr,
        weight_decay=cfg.neigh_weight_decay,
        ckpt_path=ckpt_path, ckpt_config=dataclasses.asdict(cfg),
        seed=cfg.seed, log_fn=log_fn, resume=resume,
        val_every=cfg.val_every, eval_tgt_cfg=tgt_cfg, device=device, **kw)
    return result, tgt_cfg, qry_cfg


def neighborhood_predictions(params, tgt_cfg, query_embs,
                             stage: StageData, cfg: PipelineConfig, device):
    """(counts, verified): (#neighborhoods, Q) de-logged stage-1 counts,
    clamped to the combinatorial neighborhood bound when cfg.clamp_counts
    and exact-recounted on the top tail when cfg.verify_budget > 0, and
    the neighborhood row indices whose counts are now EXACT."""
    counts = train_loop.predict_neighborhood_counts(
        params, tgt_cfg, query_embs, stage.batches, device)
    verified = np.zeros(0, np.int64)
    if cfg.clamp_counts:
        from .truth.bounds import clamp_counts

        ubs = stage_bounds(stage, cfg,
                           canonical_type=tgt_cfg.canonical_type,
                           device=device)
        counts = clamp_counts(counts, ubs)
    if cfg.exact_size > 0:
        # exact small-query columns BEFORE the tail ranking, so the
        # verifier's per-column top-k sees exact values there
        counts, _ = exact_small_counts(counts, stage, cfg)
    if cfg.verify_budget > 0:
        counts, verified = verify_tail_counts(counts, stage, cfg)
    return counts, verified


def verify_tail_counts(counts: np.ndarray, stage: StageData,
                       cfg: PipelineConfig):
    """Exact-recount the top predicted tail: per QUERY COLUMN, the
    ceil(verify_budget * N) neighborhoods with the largest predicted
    count — unioned across columns and with the top-k by row total — are
    replaced by exact canonical counts from the thread-pooled native VF2
    run on their own (<= depth-d) neighborhood subgraphs. Uses only the
    input graph. Returns (counts copy, verified row indices)."""
    queries = pipeline_queries(cfg)
    n = counts.shape[0]
    k = max(1, int(np.ceil(cfg.verify_budget * n)))
    by_total = np.argsort(-counts.sum(axis=1))[:k]
    by_col = np.argpartition(-counts, min(k, n - 1), axis=0)[:k]
    flagged = np.unique(np.concatenate([by_total, by_col.ravel()]))

    from .graph.canonical import canonical_neighborhood
    from .truth import native as truth_native

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
    per_nb = truth_native.parallel_canonical_counts(
        [nb.graph for nb in nbs], queries, cfg.num_workers)
    for nb, i, cc in zip(nbs, rows, per_nb):
        counts[i] = cc[nb.canonical]
    return counts, row_arr


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
    from .truth import native as truth_native

    graphs, canon = [], []
    for s in stage.samples:
        # each undirected edge is listed in both orientations
        und = s.edge_src < s.edge_dst
        edges = np.stack(
            [s.edge_src[und], s.edge_dst[und]], 1).astype(np.int32)
        graphs.append(Graph(s.n_nodes, edges))
        canon.append(int(np.argmax(s.node_type == CANONICAL)))
    counts = counts.copy()
    per_nb = truth_native.parallel_canonical_counts(
        graphs, sub_queries, cfg.num_workers)
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
                 canonical_type: int = 1, *, device) -> np.ndarray:
    """(#neighborhoods, Q) combinatorial upper bounds of a request,
    computed once and memoized on the StageData (the stage-1 clamp and
    the stage-3 node clamp use the same bounds)."""
    key = (canonical_type, tuple(cfg.query_ids))
    cache = getattr(stage, "_bounds_cache", None)
    if cache is None or cache[0] != key:
        from .truth.bounds import neighborhood_count_bounds

        cached = neighborhood_count_bounds(
            stage.batches, pipeline_queries(cfg),
            canonical_type=canonical_type, device=device)
        object.__setattr__(stage, "_bounds_cache", (key, cached))
        return cached
    return cache[1]


def clamp_node_counts(node_counts: np.ndarray, stage: StageData,
                      cfg: PipelineConfig, canonical_type: int = 1,
                      *, device) -> np.ndarray:
    """Clamp per-node (canonical) counts — the gossip-refined stage-3
    output — to [0, UB(v)], UB(v) the bound of v's canonical
    neighborhood; nodes whose neighborhood was dropped as edgeless get
    exactly 0. Returns a copy."""
    ubs = stage_bounds(stage, cfg, canonical_type=canonical_type,
                       device=device)
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
    """Packed gossip batches over the original graphs. Serving leaves
    ``need_bwd_perm`` off: the backward permutation is training-only and
    costs a full-row host lexsort per batch."""
    samples = stage.workload.gossip_samples(neigh_counts, stage.nindex,
                                            stage.truth)
    if callable(capacities):  # serving bucket selection sees the samples
        capacities = capacities(samples)
    caps = capacities or auto_capacities(samples, g_cap=cfg.gossip_batch_size)
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
    device). Fresh weights come from ``cfg.seed + 1``."""
    _check_training_config(cfg, mesh)
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
        seed=cfg.seed, log_fn=log_fn, resume=resume,
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
