"""CLI flag surface of ``python -m desco_tpu_torch.main`` — the port of
``desco_tpu/config.py``: the ``neigh_*`` and ``gossip_*`` model groups and
the optimizer and run-control group, with the paper defaults, plus
``--device``. Produces a ``PipelineConfig``. Flags of features the port
does not have yet parse and raise where they are used, naming
ROADMAP.md."""

from __future__ import annotations

import argparse

from .pipeline import PipelineConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.main",
        description="desco_tpu_torch: DeSCo in PyTorch on one CUDA device")

    n = p.add_argument_group("neighborhood counting model arguments")
    n.add_argument("--neigh_conv_type", type=str, default="SAGE",
                   help="SAGE, GIN, GCN, GAT or PNA")
    n.add_argument("--neigh_layer_num", type=int, default=8)
    n.add_argument("--neigh_input_dim", type=int, default=1)
    n.add_argument("--use_node_feature",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="labeled mode (not ported yet: ROADMAP.md M11)")
    n.add_argument("--neigh_hidden_dim", type=int, default=64)
    n.add_argument("--neigh_dropout", type=float, default=0.0)
    n.add_argument("--neigh_model_path", type=str,
                   default="ckpt/desco_tpu_torch/neigh")
    n.add_argument("--neigh_epoch_num", type=int, default=300)
    n.add_argument("--neigh_batch_size", type=int, default=512)
    n.add_argument("--depth", type=int, default=4,
                   help="depth of the canonical neighborhood")
    n.add_argument("--use_hetero", action=argparse.BooleanOptionalAction,
                   default=True)
    n.add_argument("--neigh_order", type=int, default=3, choices=[3, 4],
                   help="SHMP edge-typing order: 3 = triangle/tride "
                        "tconv (paper); 4 = 4-node edge-orbit classes (33 "
                        "types; exact host Python enumeration, molecular "
                        "scale)")
    n.add_argument("-t", "--use_tconv", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="triangle convolution (a case of SHMP)")
    n.add_argument("--neigh_weight_decay", type=float, default=0.0)
    n.add_argument("--neigh_lr", type=float, default=1e-4)
    n.add_argument("--agg_mode", type=str, default="auto",
                   choices=["auto", "pallas", "aggregate_first",
                            "transform_first", "cumsum"],
                   help="target-tower aggregation (auto: the fused CUDA "
                        "kernel on a GPU, aggregate_first on the CPU; "
                        "desco_tpu's other names map to the kernel)")
    n.add_argument("--serve_bf16", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="bfloat16 target tower at serving time (the "
                        "count head stays f32)")
    n.add_argument("--neigh_bf16_train",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="bfloat16 target tower in the train step: f32 "
                        "master parameters and gradients; validation, "
                        "checkpoints and serving stay f32 unless "
                        "--serve_bf16")
    n.add_argument("--neigh_degree_feature",
                   action=argparse.BooleanOptionalAction, default=False,
                   help="log2(1+degree) node input feature for both "
                        "towers (default zeros)")

    g = p.add_argument_group("gossip counting model arguments")
    g.add_argument("--gossip_conv_type", type=str, default="GOSSIP")
    g.add_argument("--gossip_layer_num", type=int, default=2)
    g.add_argument("--gossip_hidden_dim", type=int, default=64)
    g.add_argument("--gossip_dropout", type=float, default=0.01)
    g.add_argument("--gossip_model_path", type=str,
                   default="ckpt/desco_tpu_torch/gossip")
    g.add_argument("--gossip_epoch_num", type=int, default=30)
    g.add_argument("--gossip_batch_size", type=int, default=256)
    g.add_argument("--gossip_lr", type=float, default=1e-3)
    g.add_argument("--gossip_weight_decay", type=float, default=0.0)

    o = p.add_argument_group("optimizer arguments")
    o.add_argument("--train_dataset", type=str, default="SynNp_1827")
    o.add_argument("--valid_dataset", type=str, default="SynNp_1827")
    o.add_argument("--test_dataset", type=str, default="SynNp_256_1")
    o.add_argument("--query_sizes", type=int, nargs="+", default=[3, 4, 5])
    o.add_argument("--query_ids", type=int, nargs="+", default=None,
                   help="explicit atlas query ids (overrides "
                        "--query_sizes); accepts the extended 8-14-node "
                        "patterns (ids 8000-14004)")
    o.add_argument("--num_cpu", type=int, default=8)
    o.add_argument("--data_root", type=str, default="data")
    o.add_argument("--output_dir", type=str, default=None)
    o.add_argument("--neigh_checkpoint", type=str, nargs="+", default=None,
                   help="one path serves that model; several paths "
                        "serve and evaluate their ensemble")
    o.add_argument("--gossip_checkpoint", type=str, default=None)
    o.add_argument("--train_neigh", action="store_true")
    o.add_argument("--train_gossip", action="store_true")
    o.add_argument("--test_gossip", action="store_true")
    o.add_argument("--val_every", type=int, default=1,
                   help="run the val pass every k epochs (plateau LR "
                        "and best-ckpt selection see those epochs only)")
    o.add_argument("--seed", type=int, default=0)
    o.add_argument("--resume", action="store_true",
                   help="resume training from the .last snapshot")
    o.add_argument("--n_devices", type=int, default=0,
                   help="data-parallel devices (0 = all available)")
    o.add_argument("--device", type=str, default=None,
                   help="torch device; default CUDA (raises when no GPU "
                        "is visible), 'cpu' runs on the CPU")
    o.add_argument("--clamp_counts", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="clamp de-logged stage-1 counts to the exact "
                        "combinatorial neighborhood bound (truth/bounds.py)")
    o.add_argument("--verify_budget", type=float, default=1e-3,
                   help="fraction of neighborhoods (top predicted tail, "
                        "per query) recounted exactly with VF2; 0 disables")
    o.add_argument("--exact_size", type=int, default=0,
                   help="serve every query with <= this many nodes "
                        "EXACTLY (VF2 over all neighborhoods); 0 = fully "
                        "learned")
    o.add_argument("--compile_cache", type=str, default=None,
                   help="build cache directory: the kernels and the "
                        "native library are built there once and later "
                        "runs load them instead of recompiling")
    return p


def to_pipeline_config(args: argparse.Namespace) -> PipelineConfig:
    if args.neigh_degree_feature and args.use_node_feature:
        raise SystemExit(
            "--neigh_degree_feature and --use_node_feature are mutually "
            "exclusive: the degree write would clobber column 0 of the "
            "one-hot label features")
    if args.use_node_feature and not args.use_hetero:
        raise SystemExit(
            "--use_node_feature requires --use_hetero: the homogeneous "
            "sample packer carries no node features")
    return PipelineConfig(
        query_sizes=tuple(args.query_sizes),
        custom_query_ids=(tuple(args.query_ids)
                          if args.query_ids is not None else None),
        depth=args.depth,
        use_hetero=args.use_hetero,
        use_tconv=args.use_tconv,
        order=args.neigh_order,
        conv_type=args.neigh_conv_type,
        neigh_layer_num=args.neigh_layer_num,
        neigh_hidden_dim=args.neigh_hidden_dim,
        neigh_input_dim=args.neigh_input_dim,
        neigh_dropout=args.neigh_dropout,
        neigh_epochs=args.neigh_epoch_num,
        neigh_batch_size=args.neigh_batch_size,
        neigh_lr=args.neigh_lr,
        neigh_weight_decay=args.neigh_weight_decay,
        agg_mode=args.agg_mode,
        serve_bf16=args.serve_bf16,
        train_bf16=args.neigh_bf16_train,
        val_every=args.val_every,
        degree_feature=args.neigh_degree_feature,
        gossip_layer_num=args.gossip_layer_num,
        gossip_hidden_dim=args.gossip_hidden_dim,
        gossip_dropout=args.gossip_dropout,
        gossip_epochs=args.gossip_epoch_num,
        gossip_batch_size=args.gossip_batch_size,
        gossip_lr=args.gossip_lr,
        gossip_weight_decay=args.gossip_weight_decay,
        seed=args.seed,
        data_root=args.data_root,
        output_dir=args.output_dir,
        num_workers=args.num_cpu,
        clamp_counts=args.clamp_counts,
        verify_budget=args.verify_budget,
        exact_size=args.exact_size,
        use_node_feature=args.use_node_feature,
    )
