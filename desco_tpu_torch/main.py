"""desco_tpu_torch command line — the counterpart of desco_tpu's root
``main.py``.

    python -m desco_tpu_torch.main --train_neigh --train_gossip \\
        --test_gossip --train_dataset Syn_1827 --valid_dataset Syn_1827 \\
        --test_dataset Syn_1827_test

    python -m desco_tpu_torch.main --test_gossip \\
        --neigh_checkpoint release/r4/neigh.best \\
        --gossip_checkpoint release/r4/gossip.best \\
        --test_dataset Syn_1827_test

(the second replays the released weights). Datasets take desco_tpu's
names and suffixes (``data/datasets.py``).

Pipeline: load datasets -> exact ground truth (C++ VF2, cached) ->
canonical partition -> train/eval the SHMP neighborhood model -> scatter
stage-1 counts into gossip features -> train/eval the gossip model ->
CSV outputs and normed MSE / MAE per query size. It runs on CUDA unless
``--device cpu`` is given, and raises when no GPU is visible. Every conv
type (``--neigh_conv_type``), order-4 typing (``--neigh_order 4``), the
homogeneous samples (``--no-use_hetero``) and labeled mode
(``--use_node_feature --neigh_input_dim <labels>``, on datasets that
carry node labels) run; several ``--neigh_checkpoint`` paths evaluate
their ensemble. The two ablation drivers (``ablation_gnns``,
``ablation_wo_canonical``) sit beside it. ``--n_devices`` (default 0,
every visible GPU) above 1 trains both stages and predicts over that many
data-parallel replicas (parallel/dp.py); the count is clamped to the
visible GPUs, and on the CPU it is taken as given. Launched by torchrun,
as desco_tpu's ``main.py`` runs on every host of a slice, the ranks form
a process group first (utils/distributed.py) and the replicas span them,
``--n_devices`` counting every rank's (a multiple of the ranks; each
rank computes on one card, so two ranks on one card are two replicas):

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m desco_tpu_torch.main --n_devices 2 --train_neigh ...

Every rank trains both stages and predicts the same arrays; rank 0 alone
writes the output files and checkpoints and prints. ``--compile_cache
DIR`` builds the kernels into DIR once for every later run. The training
steps and the stage-1, bounds and gossip predict forwards replay CUDA
graphs, as desco_tpu jits them; the predicts share one set of caches
(``utils/cuda_graphs.ServingGraphs``), as a service's requests do.
"""

from __future__ import annotations

import contextlib
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
from .parallel.dp import dp_predict_gossip_counts, make_mesh
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
from .utils.compile_cache import enable_compilation_cache
from .utils import distributed
from .utils.cuda_graphs import ServingGraphs
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
    if distributed.launched_world() == 1:
        return _run(args)
    # under torchrun: the process group first, then the run; the ranks
    # but 0 print nothing
    distributed.init(resolve_device(args.device))
    try:
        with contextlib.ExitStack() as stack:
            if distributed.rank() != 0:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            return _run(args)
    finally:
        distributed.shutdown()


def _run(args) -> int:
    cfg = to_pipeline_config(args)
    if args.compile_cache:
        enable_compilation_cache(args.compile_cache)
    device = resolve_device(args.device)
    world = distributed.world()
    lead = distributed.rank() == 0  # writes the output files
    if world > 1:
        device = distributed.rank_device(device)
    # the data-parallel mesh: 0 = every visible GPU, a count clamped to
    # the visible GPUs (desco_tpu clamps to its devices), every rank's
    # card in a process group; on the CPU the count as given stands in
    # for desco_tpu's fake host devices
    if device.type == "cuda":
        n_avail = world if world > 1 else torch.cuda.device_count()
    else:
        n_avail = max(args.n_devices, world)
    n_dev = min(args.n_devices if args.n_devices > 0 else n_avail, n_avail)
    # the forwards run over ``mesh``; one replica trains with the
    # single-device step
    mesh = make_mesh(n_dev, device)
    train_mesh = mesh if mesh.size > 1 else None
    if train_mesh is not None:
        print(f"data-parallel mesh: {mesh.size} devices"
              + (f" over {world} processes (backend "
                 f"{distributed.backend()})" if world > 1 else ""))

    if not args.train_neigh and args.neigh_checkpoint:
        cfg = _adopt_checkpoint_config(cfg, args.neigh_checkpoint[0])

    output_dir = args.output_dir or os.path.join(
        "output", args.test_dataset,
        datetime.datetime.now().strftime("%Y%m%d_%H%M%S"))
    if lead:
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

    # datasets load exactly as named (with their node labels in labeled
    # mode); train = valid is one stage
    def load(name):
        return load_data(name, cfg.data_root,
                         with_labels=cfg.use_node_feature)

    # in a process group rank 0 fills the datasets' disk caches (truth,
    # samples) first and the other ranks read them
    with distributed.rank_zero_first():
        if args.train_neigh or args.train_gossip:
            with _phase(f"load+truth+stage {args.train_dataset}"):
                train_stage = prepare_stage_data(
                    cfg, load(args.train_dataset), name=args.train_dataset,
                    need_truth=True)
            val_stage = (
                train_stage if args.valid_dataset == args.train_dataset
                else prepare_stage_data(cfg, load(args.valid_dataset),
                                        name=args.valid_dataset,
                                        need_truth=True))
        with _phase(f"load+truth+stage {args.test_dataset}"):
            test_graphs = load(args.test_dataset)
            test_stage = prepare_stage_data(cfg, test_graphs,
                                            name=args.test_dataset,
                                            need_truth=True)
    print(f"{args.test_dataset}: {len(test_graphs)} graphs, "
          f"{test_stage.workload.total_nodes} nodes, "
          f"{len(test_stage.samples)} neighborhoods in "
          f"{len(test_stage.batches)} target batches")
    if cfg.order == 4:  # orbit typing is host Python: say what it cost
        staged = {args.test_dataset: test_stage}
        if args.train_neigh or args.train_gossip:
            staged.update({args.train_dataset: train_stage,
                           args.valid_dataset: val_stage})
        for name, st in staged.items():
            if st.workload.typing_seconds is not None:
                print(f"[timing] order-4 orbit typing {name}: "
                      f"{st.workload.typing_seconds:.1f}s for "
                      f"{len(st.samples)} neighborhoods")

    # ---------------------------------------------- neighborhood stage
    if args.train_neigh:
        print("training neighborhood model...")
        res, tgt_cfg, qry_cfg = train_neighborhood_stage(
            cfg, train_stage, val_stage, qb, device=device, mesh=train_mesh,
            ckpt_path=args.neigh_model_path, resume=args.resume)
        members = [res.best_params]
        print(f"best neighborhood val loss: {res.best_val:.5f}")
    else:
        if not args.neigh_checkpoint:
            raise SystemExit("need --train_neigh or --neigh_checkpoint")
        # several checkpoints evaluate their ensemble (stage-1
        # predictions averaged in log2(count + 1) space)
        members = [load_checkpoint(c)[0] for c in args.neigh_checkpoint]
        print(f"loaded neighborhood model from "
              f"{', '.join(args.neigh_checkpoint)}")
    members = [p.requires_grad_(False).to(device) for p in members]
    with torch.inference_mode():
        q_dev = qb.to(device)
        member_embs = [neigh_mod.embed_queries(p, qry_cfg, q_dev)
                       for p in members]
    # gossip conditions on one query tower: the first member's
    neigh_params, query_embs = members[0], member_embs[0]
    # the predicts' compiled forwards, kept across the test, train and
    # val predicts and the gossip stage
    graphs = ServingGraphs(len(members))

    # stage-1 predictions (verified rows carry EXACT counts)
    with _phase("stage-1 predict+verify (test)"):
        counts_test, verified_rows = neighborhood_predictions(
            members, tgt_cfg, member_embs, test_stage, cfg, device, mesh,
            graphs=graphs)
    counts = {"test": counts_test}
    # train/val stage-1 predictions feed ONLY gossip training
    if args.train_gossip:
        counts["train"] = neighborhood_predictions(
            members, tgt_cfg, member_embs, train_stage, cfg, device,
            mesh, graphs=graphs)[0]
        counts["val"] = (
            counts["train"] if val_stage is train_stage
            else neighborhood_predictions(
                members, tgt_cfg, member_embs, val_stage, cfg, device,
                mesh, graphs=graphs)[0])

    # ---------------------------------------------------- gossip stage
    gossip_node_counts = None
    if args.train_gossip or args.test_gossip:
        with _phase("gossip batch prep (test)"):
            test_gbatches = prepare_gossip_batches(cfg, test_stage,
                                                   counts["test"])
        print(f"{args.test_dataset}: {len(test_gbatches)} gossip batches")
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
                device=device, mesh=train_mesh,
                ckpt_path=args.gossip_model_path,
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
            gossip_node_counts = dp_predict_gossip_counts(
                gossip_params, query_embs, test_gbatches, mesh,
                cache=graphs.gossip)
        if cfg.clamp_counts:
            # same combinatorial bound as stage 1, applied to the refined
            # per-node counts; verified-exact rows are restored after
            gossip_node_counts = clamp_node_counts(
                gossip_node_counts, test_stage, cfg,
                canonical_type=tgt_cfg.canonical_type, device=device,
                cache=graphs.bounds)
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
        if lead:
            _save_csv(output_dir, f"gossip_gate_{args.test_dataset}.csv",
                      gates)

    # -------------------------------------------------------- outputs
    metrics = evaluate_graphlet_counts(cfg, test_stage, counts["test"],
                                       gossip_node_counts)
    if lead:
        _write_outputs(output_dir, args.test_dataset, test_stage,
                       test_graphs, counts["test"], gossip_node_counts,
                       metrics)
    for k, v in metrics.items():
        print(f"graphlet_{k}: {v}")
    print("done")
    return 0


def _write_outputs(output_dir: str, name: str, test_stage, test_graphs,
                   neigh_counts: np.ndarray, gossip_node_counts,
                   metrics: dict) -> None:
    """The CSV, npz and text outputs of a run (desco_tpu's names)."""
    wl = test_stage.workload
    graphlet_neigh = wl.aggregate_neighborhood_counts(
        neigh_counts, test_stage.nindex)
    _save_csv(output_dir, f"neighborhood_graphlet_{name}.csv",
              round_relu(graphlet_neigh))
    _save_csv(output_dir, f"neighborhood_node_{name}_results.csv",
              neigh_counts)
    _save_csv(output_dir, f"neighborhood_node_{name}_index.csv",
              test_stage.nindex.index)
    final_graphlet = graphlet_neigh
    if gossip_node_counts is not None:
        final_graphlet = wl.aggregate_node_counts(gossip_node_counts)
        _save_csv(output_dir, f"gossip_graphlet_{name}.csv",
                  round_relu(final_graphlet))
        _save_csv(output_dir, f"gossip_node_{name}_results.csv",
                  gossip_node_counts)
    # the pipeline's final graphlet counts (gossip-refined when stage 3
    # ran, stage-1 otherwise) + exact truth, for external analysis
    _save_csv(output_dir, f"graphlet_count_{name}.csv",
              round_relu(final_graphlet))
    _save_csv(output_dir, f"graphlet_truth_{name}.csv",
              wl.aggregate_node_counts(test_stage.truth))
    np.savez_compressed(
        os.path.join(output_dir, f"test_graphs_{name}.npz"),
        edges=np.concatenate([g.edges for g in test_graphs], axis=0),
        edge_offsets=np.concatenate(
            [[0], np.cumsum([g.n_edges for g in test_graphs])]),
        n_nodes=np.array([g.n_nodes for g in test_graphs]))
    with open(os.path.join(output_dir, f"analyze_results_{name}.txt"),
              "w") as f:
        for k, v in metrics.items():
            f.write(f"graphlet_{k}: {v}\n")


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
