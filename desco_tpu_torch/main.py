"""desco_tpu_torch command line — the counterpart of desco_tpu's root
``main.py`` for one device.

    python -m desco_tpu_torch.main --train_neigh --train_gossip \\
        --test_gossip --train_dataset SynNp_1827 --test_dataset SynNp_256_1

Pipeline: load datasets -> exact ground truth (C++ VF2, cached) ->
canonical partition -> train/eval the SHMP neighborhood model -> scatter
stage-1 counts into gossip features -> train/eval the gossip model ->
CSV outputs and normed MSE / MAE per query size. It runs on CUDA unless
``--device cpu`` is given, and raises when no GPU is visible. Checkpoint
ensembles, ``--compile_cache`` and ``--n_devices > 1`` are not ported yet
and raise (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import sys
import time

import numpy as np
import torch

from .analysis import round_relu
from .config import build_parser, to_pipeline_config
from .data.datasets import load_data
from .models import neighborhood as neigh_mod
from .models.gossip import gate_values
from .pipeline import (
    apply_exact_column_override,
    apply_verified_override,
    build_query_batch,
    clamp_node_counts,
    evaluate_graphlet_counts,
    exact_columns,
    model_configs,
    neighborhood_predictions,
    prepare_gossip_batches,
    prepare_stage_data,
    train_gossip_stage,
    train_neighborhood_stage,
)
from .train.checkpoint import load_checkpoint
from .train.loop import predict_gossip_counts
from .utils.device import resolve_device

# checkpoint config fields an eval-only run adopts (see main)
_MODEL_FIELDS = (
    "query_sizes", "depth", "use_hetero", "use_tconv", "order",
    "conv_type", "neigh_layer_num", "neigh_hidden_dim",
    "neigh_input_dim", "degree_feature", "use_node_feature",
    "custom_query_ids", "gossip_layer_num", "gossip_hidden_dim")


class _phase:
    """Wall-clock phase timer (the cost split between host packing,
    device predict and VF2 verify is the first question when a run is
    slow)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        print(f"[timing] {self.name}: "
              f"{time.perf_counter() - self.t0:.1f}s", flush=True)


def _adopt_checkpoint_config(cfg, path: str):
    """Eval-only runs adopt the checkpoint's model and feature fields: a
    checkpoint trained with other typing or features, evaluated without
    the matching flags, would stage different samples than it was trained
    on and count wrong without an error. Each adopted difference is
    announced."""
    try:
        with open(path + ".json") as f:
            saved = json.load(f).get("config") or {}
    except (OSError, ValueError):
        return cfg
    adopt = {}
    for k in _MODEL_FIELDS:
        if k not in saved:
            continue
        v = tuple(saved[k]) if isinstance(saved[k], list) else saved[k]
        if getattr(cfg, k) != v:
            print(f"adopting {k}={v!r} from checkpoint config "
                  f"(CLI had {getattr(cfg, k)!r})")
            adopt[k] = v
    return dataclasses.replace(cfg, **adopt) if adopt else cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = to_pipeline_config(args)
    if args.n_devices != 1:
        raise NotImplementedError(
            "--n_devices other than 1 (data-parallel training and "
            "serving) is not ported yet (ROADMAP.md, Queue 1 M15)")
    if args.compile_cache:
        raise NotImplementedError(
            "--compile_cache has no counterpart in the port yet "
            "(ROADMAP.md, Queue 1 M17)")
    if args.neigh_checkpoint and len(args.neigh_checkpoint) > 1:
        raise NotImplementedError(
            "checkpoint ensembles (several --neigh_checkpoint paths) are "
            "not ported yet (ROADMAP.md, Queue 1 M11)")
    device = resolve_device(args.device)

    if not args.train_neigh and args.neigh_checkpoint:
        cfg = _adopt_checkpoint_config(cfg, args.neigh_checkpoint[0])

    output_dir = args.output_dir or os.path.join(
        "output", args.test_dataset,
        datetime.datetime.now().strftime("%Y%m%d_%H%M%S"))
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir,
                           f"config_{args.test_dataset}.txt"), "w") as f:
        json.dump({"args": vars(args),
                   "pipeline": dataclasses.asdict(cfg)}, f, indent=2)

    # ---------------------------------------------------------- datasets
    print(f"loading datasets: train={args.train_dataset} "
          f"valid={args.valid_dataset} test={args.test_dataset} "
          f"(device {device})")
    qb = build_query_batch(cfg)
    tgt_cfg, qry_cfg = model_configs(cfg, device)

    # datasets load exactly as named; train = valid is one stage
    if args.train_neigh or args.train_gossip:
        with _phase(f"load+truth+stage {args.train_dataset}"):
            train_stage = prepare_stage_data(
                cfg, load_data(args.train_dataset, cfg.data_root),
                name=args.train_dataset, need_truth=True)
        val_stage = (
            train_stage if args.valid_dataset == args.train_dataset
            else prepare_stage_data(
                cfg, load_data(args.valid_dataset, cfg.data_root),
                name=args.valid_dataset, need_truth=True))
    with _phase(f"load+truth+stage {args.test_dataset}"):
        test_graphs = load_data(args.test_dataset, cfg.data_root)
        test_stage = prepare_stage_data(cfg, test_graphs,
                                        name=args.test_dataset,
                                        need_truth=True)

    # ---------------------------------------------- neighborhood stage
    if args.train_neigh:
        print("training neighborhood model...")
        res, tgt_cfg, qry_cfg = train_neighborhood_stage(
            cfg, train_stage, val_stage, qb, device=device,
            ckpt_path=args.neigh_model_path, resume=args.resume)
        neigh_params = res.best_params
        print(f"best neighborhood val loss: {res.best_val:.5f}")
    else:
        if not args.neigh_checkpoint:
            raise SystemExit("need --train_neigh or --neigh_checkpoint")
        neigh_params = load_checkpoint(args.neigh_checkpoint[0])[0]
        print(f"loaded neighborhood model from {args.neigh_checkpoint[0]}")
    neigh_params = neigh_params.requires_grad_(False).to(device)
    with torch.inference_mode():
        query_embs = neigh_mod.embed_queries(neigh_params, qry_cfg,
                                             qb.to(device))

    # stage-1 predictions (verified rows carry EXACT counts)
    with _phase("stage-1 predict+verify (test)"):
        counts_test, verified_rows = neighborhood_predictions(
            neigh_params, tgt_cfg, query_embs, test_stage, cfg, device)
    counts = {"test": counts_test}
    # train/val stage-1 predictions feed ONLY gossip training
    if args.train_gossip:
        counts["train"] = neighborhood_predictions(
            neigh_params, tgt_cfg, query_embs, train_stage, cfg, device)[0]
        counts["val"] = (
            counts["train"] if val_stage is train_stage
            else neighborhood_predictions(
                neigh_params, tgt_cfg, query_embs, val_stage, cfg,
                device)[0])

    # ---------------------------------------------------- gossip stage
    gossip_node_counts = None
    if args.train_gossip or args.test_gossip:
        with _phase("gossip batch prep (test)"):
            test_gbatches = prepare_gossip_batches(cfg, test_stage,
                                                   counts["test"])
        if args.train_gossip:
            print("training gossip model...")
            train_gb = prepare_gossip_batches(
                cfg, train_stage, counts["train"], need_bwd_perm=True)
            val_gb = (train_gb if val_stage is train_stage
                      else prepare_gossip_batches(
                          cfg, val_stage, counts["val"],
                          need_bwd_perm=True))
            gres, _ = train_gossip_stage(
                cfg, neigh_params, tgt_cfg, qry_cfg, qb, train_gb, val_gb,
                device=device, ckpt_path=args.gossip_model_path,
                resume=args.resume)
            gossip_params = gres.best_params
            print(f"best gossip val loss: {gres.best_val:.5f}")
        else:
            if args.gossip_checkpoint is None:
                raise SystemExit(
                    "need --train_gossip or --gossip_checkpoint")
            gossip_params = load_checkpoint(args.gossip_checkpoint)[0]
            print(f"loaded gossip model from {args.gossip_checkpoint}")
        gossip_params = gossip_params.requires_grad_(False).to(device)

        with _phase("gossip predict (test)"):
            gossip_node_counts = predict_gossip_counts(
                gossip_params, query_embs, test_gbatches, device)
        if cfg.clamp_counts:
            # same combinatorial bound as stage 1, applied to the refined
            # per-node counts; verified-exact rows are restored after
            gossip_node_counts = clamp_node_counts(
                gossip_node_counts, test_stage, cfg,
                canonical_type=tgt_cfg.canonical_type, device=device)
        gossip_node_counts = apply_verified_override(
            gossip_node_counts, counts["test"], verified_rows,
            test_stage.nindex)
        if cfg.exact_size > 0:
            gossip_node_counts = apply_exact_column_override(
                gossip_node_counts, counts["test"], exact_columns(cfg),
                test_stage.nindex)

        # gossip gate analysis
        with torch.inference_mode():
            gates = gate_values(gossip_params, query_embs).cpu().numpy()
        _save_csv(output_dir, f"gossip_gate_{args.test_dataset}.csv", gates)

    # -------------------------------------------------------- outputs
    wl = test_stage.workload
    graphlet_neigh = wl.aggregate_neighborhood_counts(
        counts["test"], test_stage.nindex)
    _save_csv(output_dir, f"neighborhood_graphlet_{args.test_dataset}.csv",
              round_relu(graphlet_neigh))
    _save_csv(output_dir, f"neighborhood_node_{args.test_dataset}_results.csv",
              counts["test"])
    _save_csv(output_dir, f"neighborhood_node_{args.test_dataset}_index.csv",
              test_stage.nindex.index)
    final_graphlet = graphlet_neigh
    if gossip_node_counts is not None:
        final_graphlet = wl.aggregate_node_counts(gossip_node_counts)
        _save_csv(output_dir, f"gossip_graphlet_{args.test_dataset}.csv",
                  round_relu(final_graphlet))
        _save_csv(output_dir, f"gossip_node_{args.test_dataset}_results.csv",
                  gossip_node_counts)
    # the pipeline's final graphlet counts (gossip-refined when stage 3
    # ran, stage-1 otherwise) + exact truth, for external analysis
    _save_csv(output_dir, f"graphlet_count_{args.test_dataset}.csv",
              round_relu(final_graphlet))
    _save_csv(output_dir, f"graphlet_truth_{args.test_dataset}.csv",
              wl.aggregate_node_counts(test_stage.truth))
    np.savez_compressed(
        os.path.join(output_dir, f"test_graphs_{args.test_dataset}.npz"),
        edges=np.concatenate([g.edges for g in test_graphs], axis=0),
        edge_offsets=np.concatenate(
            [[0], np.cumsum([g.n_edges for g in test_graphs])]),
        n_nodes=np.array([g.n_nodes for g in test_graphs]))

    # -------------------------------------------------------- analysis
    metrics = evaluate_graphlet_counts(cfg, test_stage, counts["test"],
                                       gossip_node_counts)
    for k, v in metrics.items():
        print(f"graphlet_{k}: {v}")
    with open(os.path.join(
            output_dir, f"analyze_results_{args.test_dataset}.txt"),
            "w") as f:
        for k, v in metrics.items():
            f.write(f"graphlet_{k}: {v}\n")
    print("done")
    return 0


def _save_csv(output_dir: str, name: str, arr: np.ndarray) -> None:
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr[:, None]
    header = "," + ",".join(str(i) for i in range(arr.shape[1]))
    rows = "\n".join(
        f"{i}," + ",".join(repr(float(x)) for x in row)
        for i, row in enumerate(arr))
    with open(os.path.join(output_dir, name), "w") as f:
        f.write(header + "\n" + rows + "\n")


if __name__ == "__main__":
    sys.exit(main())
