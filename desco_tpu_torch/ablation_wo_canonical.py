"""Ablation: no canonical partition (whole-graph counting) — the port's
counterpart of desco_tpu's root ``ablation_wo_canonical.py``.

The neighborhood model regresses graph-level (graphlet) counts on WHOLE
graphs, each one untyped sample (``Workload.wo_canonical_samples``): no
neighborhood decomposition, no anchor node. Both towers are query-tower
models (``query_config``), so on the card the target tower aggregates
through the gather-fused K1 (desco_tpu's default ``aggregate_first``
mode). Train, validation and test graphs are ``<train_dataset>_train``,
``<valid_dataset>_val`` and ``<test_dataset>``, as in desco_tpu. It
takes main's flags and runs on the card unless ``--device cpu`` is given;
it prints the best validation loss and the test set's graphlet normed
MSE and MAE per query size.

    python -m desco_tpu_torch.ablation_wo_canonical --train_dataset \\
        Syn_1827 --valid_dataset Syn_1827 --test_dataset Syn_1827_test
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    from .analysis import mae, norm_mse, round_relu
    from .batch.packed import auto_capacities, pack_samples
    from .config import build_parser, to_pipeline_config
    from .data.datasets import load_data
    from .data.workload import Workload
    from .models import neighborhood as neigh_mod
    from .models.shmp_gnn import query_config
    from .pipeline import build_query_batch, pipeline_query_groups
    from .train import loop as train_loop
    from .utils.device import resolve_device

    args = build_parser().parse_args(argv)
    cfg = to_pipeline_config(args)
    device = resolve_device(args.device)
    qb = build_query_batch(cfg)
    # both towers are union_node models (no canonical type, anchor unused)
    tgt_cfg = query_config(
        use_tconv=cfg.use_tconv, input_dim=cfg.neigh_input_dim,
        hidden_dim=cfg.neigh_hidden_dim, output_dim=cfg.neigh_hidden_dim,
        layer_num=cfg.neigh_layer_num, conv_type=cfg.conv_type,
        dropout=cfg.neigh_dropout)
    qry_cfg = tgt_cfg
    print(f"wo_canonical: train={args.train_dataset}_train "
          f"valid={args.valid_dataset}_val test={args.test_dataset} "
          f"(device {device})", flush=True)

    def stage(name, need_bwd_perm):
        graphs = load_data(name, cfg.data_root)
        wl = Workload(graphs, root=os.path.join(cfg.data_root, name),
                      name=name)
        samples = wl.wo_canonical_samples(cfg.query_ids,
                                          use_tconv=cfg.use_tconv,
                                          num_workers=cfg.num_workers)
        caps = auto_capacities(samples, g_cap=cfg.neigh_batch_size)
        return samples, pack_samples(samples, *caps,
                                     n_queries=len(cfg.query_ids),
                                     need_bwd_perm=need_bwd_perm)

    _, b_tr = stage(args.train_dataset + "_train", True)
    _, b_va = stage(args.valid_dataset + "_val", True)
    s_te, b_te = stage(args.test_dataset, False)
    print(f"{args.test_dataset}: {len(s_te)} whole graphs in {len(b_te)} "
          f"batches; {len(b_tr)} train, {len(b_va)} validation batches",
          flush=True)

    params = neigh_mod.init_neighborhood_model(
        tgt_cfg, qry_cfg, torch.Generator().manual_seed(cfg.seed))
    res = train_loop.train_neighborhood(
        params, tgt_cfg, qry_cfg, qb, b_tr, b_va,
        epochs=cfg.neigh_epochs, lr=cfg.neigh_lr,
        weight_decay=cfg.neigh_weight_decay, seed=cfg.seed, device=device)
    print(f"best val loss: {res.best_val:.5f}")

    best = res.best_params.requires_grad_(False).to(device)
    with torch.inference_mode():
        query_embs = neigh_mod.embed_queries(best, qry_cfg, qb.to(device))
    preds = train_loop.predict_neighborhood_counts(
        best, tgt_cfg, query_embs, b_te, device)
    truth = np.stack([s.y for s in s_te])
    groups = pipeline_query_groups(cfg)
    print(f"wo_canonical graphlet_norm_mse: "
          f"{norm_mse(round_relu(preds), truth, groups)}")
    print(f"wo_canonical graphlet_mae: "
          f"{mae(round_relu(preds), truth, groups)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
