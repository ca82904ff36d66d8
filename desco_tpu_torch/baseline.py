"""Baseline driver: whole-graph counting with DIAMNet or LRP — the port's
counterpart of desco_tpu's root ``baseline.py``.

    python -m desco_tpu_torch.baseline --baseline DIAMNET \\
        --train_dataset Syn_1827 --test_dataset Syn_1827_test
    python -m desco_tpu_torch.baseline --baseline LRP ...

Graph-level (graphlet) counts of the standard queries, learned on whole
graphs (``Workload.wo_canonical_samples``, one untyped sample per graph)
with the log2(count + 1) smooth-L1 loss: DIAMNet over GIN node embeddings
(``models/baseline_diamnet.py``; its graph tower runs the fused K2 / K3
on the card) or Local Relational Pooling (``models/lrp.py``). Train,
validation and test graphs are ``<train_dataset>_train``,
``<valid_dataset>_val`` and each ``--test_dataset``, as in desco_tpu;
ground truth comes from the truth cache under ``--data_root``. It trains
with the port's Adam (optax.adam's defaults), keeps the weights of the
best validation loss, and prints each test set's normed MSE and MAE per
query size, then one JSON line. It runs on the card unless ``--device
cpu`` is given.

As desco_tpu jits them, the train step, the validation loss and the
predict replay compiled graphs (utils/cuda_graphs.py), one per batch shape
(a split's batches share their caps; LRP's permutation arrays are
inputs, their padded count part of the shape), captured at their first
call with every batch's streams derived before; the losses are read
back once per epoch. ``--eager`` runs them eagerly.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m desco_tpu_torch.baseline")
    p.add_argument("--baseline", type=str, default="DIAMNET",
                   choices=["DIAMNET", "LRP"])
    p.add_argument("--train_dataset", type=str, default="Syn_64")
    p.add_argument("--valid_dataset", type=str, default=None)
    p.add_argument("--test_dataset", type=str, nargs="+",
                   default=["Syn_64"],
                   help="one or more eval sets; the model is trained "
                        "once and evaluated on each")
    p.add_argument("--query_sizes", type=int, nargs="+", default=[3, 4, 5])
    p.add_argument("--conv_type", type=str, default="GIN")
    p.add_argument("--mem_init", type=str, default="mean",
                   choices=["mean", "sum", "max", "attn", "lstm",
                            "circular_mean", "circular_sum",
                            "circular_max", "circular_attn",
                            "circular_lstm"],
                   help="DIAMNet memory init variant")
    p.add_argument("--layer_num", type=int, default=3)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--epoch_num", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default CUDA (raises when no GPU "
                        "is visible unless 'cpu' is given)")
    p.add_argument("--eager", action="store_true",
                   help="run the train step, validation and predict "
                        "eagerly instead of replaying CUDA graphs")
    return p


def init_params(kind: str, cfgs: tuple, seed: int):
    """Fresh weights of the baseline ``kind`` from ``seed``: DIAMNet's
    (tower config, DIAMNet config), LRP's (LRPConfig,)."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "LRP":
        from .models.lrp import init_lrp

        return init_lrp(cfgs[0], gen)
    from .models.baseline_diamnet import init_diamnet_pipeline

    return init_diamnet_pipeline(*cfgs, generator=gen)


def _train(params, loss_fn, train_items, val_items, epochs: int, lr: float,
           graphed: bool = True):
    """Adam over the train items each epoch, the validation loss after
    each; returns the weights of the best validation loss. ``graphed``:
    the step (``GraphedStep``) and the validation loss (``ForwardCache``)
    replay compiled graphs, one per item shape (an item's per-batch state
    derived before); else both run eagerly. The losses are read back once
    per epoch."""
    from .utils.cuda_graphs import ForwardCache, GraphedStep, signature
    from .train.loop import make_adam

    opt = make_adam(params)
    dev = opt.flat.device
    loss = torch.zeros((), device=dev)

    def step_on(item):
        opt.zero_grad()
        out = loss_fn(params, item)
        out.backward()
        opt.step(lr)
        loss.copy_(out.detach())

    def val_on(item):
        return loss_fn(params, item)

    steps, vals = {}, ForwardCache()

    def train_step(item):
        if not graphed:
            step_on(item)
        else:
            key = signature(item)
            if key not in steps:
                steps[key] = GraphedStep(
                    step_on, item, capture=dev.type == "cuda",
                    state=opt.state_tensors() + [loss])
            steps[key](item)
        return loss.clone()

    def val_loss(item):
        if graphed:
            return vals(val_on, (item,), static="val")
        with torch.no_grad():
            return val_on(item)

    def read(values):
        return [float(v) for v in torch.stack(values).tolist()]

    best_val, best_params = float("inf"), params
    for epoch in range(epochs):
        t0 = time.time()
        losses = read([train_step(item) for item in train_items])
        vl = float(np.mean(read([val_loss(it) for it in val_items])))
        if vl < best_val:
            best_val, best_params = vl, copy.deepcopy(params)
        if epoch % 10 == 0 or epoch == epochs - 1:
            print(f"epoch {epoch:4d} train {np.mean(losses):.5f} "
                  f"val {vl:.5f} {time.time() - t0:.1f}s", flush=True)
    print(f"best val {best_val:.5f}")
    return best_params.requires_grad_(False)


def _report(tag, name, preds, truths, groups) -> None:
    from .analysis import mae, norm_mse

    nm = norm_mse(preds, truths, groups)
    ma = mae(preds, truths, groups)
    print(f"{tag} {name} graphlet_norm_mse:", nm)
    print(f"{tag} {name} graphlet_mae:", ma)
    print(json.dumps({"baseline": tag, "dataset": name,
                      "norm_mse": [float(v) for v in nm],
                      "mae": [float(v) for v in ma]}), flush=True)


def _evaluate(tag, test_sets, predict, groups) -> None:
    """De-logged graphlet counts of each test set against its truth.
    ``predict(i, batch)`` -> [G, Q] log-space predictions of batch i."""
    from .analysis import round_relu

    for name, batches in test_sets:
        preds, truths = [], []
        with torch.no_grad():
            for i, b in enumerate(batches):
                # log-space clamp before the de-log: no graph here holds
                # 2^60 occurrences of a size <= 5 query; it only keeps a
                # diverged prediction from overflowing to inf
                out = (2.0 ** predict(name, i, b).clamp(max=60.0)
                       - 1.0).cpu().numpy()
                valid = np.asarray(b.graph_mask) > 0
                preds.append(out[valid])
                truths.append(np.asarray(b.y)[valid])
        _report(tag, name, round_relu(np.concatenate(preds)),
                np.concatenate(truths), groups)


def main(argv=None) -> int:
    from .batch.build import query_sample
    from .batch.packed import auto_capacities, pack_samples
    from .data.datasets import load_data
    from .data.workload import Workload
    from .graph.atlas import gen_queries, gen_query_ids
    from .pipeline import PipelineConfig, pipeline_query_groups
    from .utils.device import resolve_device

    args = build_parser().parse_args(argv)
    args.valid_dataset = args.valid_dataset or args.train_dataset
    device = resolve_device(args.device)
    qids = gen_query_ids(args.query_sizes)
    print(f"baseline {args.baseline}: train={args.train_dataset}_train "
          f"valid={args.valid_dataset}_val test={args.test_dataset} "
          f"(device {device})", flush=True)

    def stage(name):
        graphs = load_data(name, args.data_root)
        wl = Workload(graphs, root=f"{args.data_root}/{name}", name=name)
        samples = wl.wo_canonical_samples(
            qids, use_tconv=False, truth=wl.compute_groundtruth(qids))
        caps = auto_capacities(samples, g_cap=args.batch_size)
        return pack_samples(samples, *caps, n_queries=len(qids))

    train_b = stage(args.train_dataset + "_train")
    val_b = stage(args.valid_dataset + "_val")
    test_sets = [(name, stage(name)) for name in args.test_dataset]
    groups = pipeline_query_groups(
        PipelineConfig(query_sizes=tuple(args.query_sizes)))
    if args.baseline == "LRP":
        return run_lrp(args, qids, train_b, val_b, test_sets, groups,
                       device)

    from .models.baseline_diamnet import (
        DIAMNetConfig, diamnet_forward, diamnet_tower_config,
        diamnet_train_loss, node_positions)
    from .models.shmp_gnn import prepare_batch
    from .ops.cuda_segment import default_agg_mode
    from .utils.cuda_graphs import ForwardCache

    qs = [query_sample(q, use_tconv=False) for q in gen_queries(qids)]
    [qb] = pack_samples(qs, *auto_capacities(qs, g_cap=len(qs)))
    q_dev = qb.to(device)
    q_pos = torch.as_tensor(node_positions(qb), device=device)
    q_seq_len = max(args.query_sizes)
    # the graph tower aggregates as the target tower does on this device
    # (K2 / K3 on the card), the pattern tower as the query tower
    graph_cfg = diamnet_tower_config(args.hidden_dim, args.layer_num,
                                     args.conv_type,
                                     agg_mode=default_agg_mode(device))
    pattern_cfg = diamnet_tower_config(args.hidden_dim, args.layer_num,
                                       args.conv_type)
    dn_cfg = DIAMNetConfig(pattern_dim=args.hidden_dim,
                           graph_dim=args.hidden_dim,
                           hidden_dim=args.hidden_dim,
                           mem_init=args.mem_init)
    params = init_params("DIAMNET", (pattern_cfg, dn_cfg),
                         args.seed).to(device)
    # sequence length: the most nodes of one graph over every split
    seq_len = max(
        int(np.bincount(np.asarray(b.node_graph)[
            np.asarray(b.node_mask) > 0]).max())
        for bs in [train_b, val_b] + [t for _, t in test_sets] for b in bs)

    # the towers' streams, derived before any step or forward (a compiled
    # one cannot hold the read-back of their derivation)
    prepare_batch(q_dev, pattern_cfg.n_edge_types, backward=True)

    def on_device(batches, training, backward):
        out = []
        for b in batches:
            b_dev = b.to(device, training=training)
            prepare_batch(b_dev, graph_cfg.n_edge_types, backward)
            out.append((b_dev, torch.as_tensor(node_positions(b),
                                               device=device)))
        return out

    def loss_fn(p, item):
        b, pos = item
        return diamnet_train_loss(p, graph_cfg, pattern_cfg, dn_cfg, b, pos,
                                  seq_len, q_dev, q_pos, q_seq_len)

    graphed = not args.eager
    params = _train(params, loss_fn, on_device(train_b, True, True),
                    on_device(val_b, True, False), args.epoch_num, args.lr,
                    graphed)
    forwards = ForwardCache()

    def forward(b, pos):
        return diamnet_forward(params, graph_cfg, pattern_cfg, dn_cfg, b,
                               pos, seq_len, q_dev, q_pos, q_seq_len)

    def predict(name, i, b):
        [(b_dev, pos)] = on_device([b], False, False)
        if graphed:
            return forwards(forward, (b_dev, pos), static="predict")
        return forward(b_dev, pos)

    _evaluate("DIAMNET", test_sets, predict, groups)
    return 0


def run_lrp(args, qids, train_b, val_b, test_sets, groups, device) -> int:
    from .models.lrp import LRPConfig, apply_lrp_batch, lrp_arrays_for_batch
    from .models.neighborhood import smooth_l1
    from .utils.cuda_graphs import ForwardCache

    cfg = LRPConfig(hid_dim=args.hidden_dim, num_layers=args.layer_num,
                    num_tasks=len(qids))
    params = init_params("LRP", (cfg,), args.seed).to(device)

    def prep(batches, training=True):
        """Each batch on the device with its permutation arrays, padded
        to one permutation count (desco_tpu's, a multiple of 128)."""
        arrs = [lrp_arrays_for_batch(b, cfg) for b in batches]
        p_cap = max(a[0].shape[0] for a in arrs)
        p_cap = ((p_cap + 127) // 128) * 128
        return [(b.to(device, training=training),
                 [torch.as_tensor(a, device=device)
                  for a in lrp_arrays_for_batch(b, cfg, p_cap=p_cap)])
                for b in batches]

    def loss_fn(p, item):
        b, arrs = item
        pred = apply_lrp_batch(p, cfg, b, *arrs)
        target = torch.log2(b.y + 1.0)
        m = b.graph_mask
        per_q = (smooth_l1(pred, target) * m[:, None]).sum(0) / \
            m.sum().clamp(min=1.0)
        return per_q.mean()

    graphed = not args.eager
    params = _train(params, loss_fn, prep(train_b), prep(val_b),
                    args.epoch_num, args.lr, graphed)
    prepped = {name: prep(batches, training=False)
               for name, batches in test_sets}
    forwards = ForwardCache()

    def forward(b_dev, arrs):
        return apply_lrp_batch(params, cfg, b_dev, *arrs)

    def predict(name, i, b):
        item = prepped[name][i]
        if graphed:
            return forwards(forward, item, static="predict")
        return forward(*item)

    _evaluate("LRP", test_sets, predict, groups)
    return 0


if __name__ == "__main__":
    sys.exit(main())
