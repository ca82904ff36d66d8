"""Serving-knob study: exact-verification budget vs accuracy vs cost.

    python -m desco_tpu_torch.tools.verify_sweep --dataset EgoProxy \\
        --neigh_checkpoint release/r4/neigh.best \\
        --budgets 0 0.001 0.01 0.03 [--device cpu]

The port of desco_tpu's ``analysis/verify_sweep.py``, with its flags and
printed lines (and ``--device``: the card by default). Serving recounts
the top ``verify_budget`` fraction of neighborhoods exactly (per-query
column top-k union, ``pipeline.verify_tail_counts``) with the native
VF2. The sweep runs ONE forward with clamp at budget 0 on the card, then
only the verification pass per budget, so each budget's wall clock
isolates the knob; it prints the rows verified, the seconds and the
graphlet normed MSE per query size. Several ``--neigh_checkpoint`` paths
serve their ensemble.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.tools.verify_sweep")
    p.add_argument("--dataset", required=True)
    p.add_argument("--neigh_checkpoint", nargs="+", required=True)
    p.add_argument("--budgets", type=float, nargs="+",
                   default=[0.0, 1e-3, 1e-2, 3e-2])
    p.add_argument("--data_root", default="data")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def run(args, log=print) -> dict:
    """Returns one row per budget: rows verified, seconds, the normed
    MSE per query size, and the counts."""
    import torch

    from ..data.datasets import load_data
    from ..models import neighborhood as neigh_mod
    from ..pipeline import (
        PipelineConfig, build_query_batch, evaluate_graphlet_counts,
        model_configs, neighborhood_predictions, prepare_stage_data,
        verify_tail_counts)
    from ..train.checkpoint import load_checkpoint
    from ..utils.device import device_label, resolve_device

    device = resolve_device(args.device)
    cfg = PipelineConfig(data_root=args.data_root)
    tgt_cfg, qry_cfg = model_configs(cfg, device)
    qb = build_query_batch(cfg).to(device)
    members = [load_checkpoint(c)[0].requires_grad_(False).to(device)
               for c in args.neigh_checkpoint]
    with torch.inference_mode():
        embs = [neigh_mod.embed_queries(p, qry_cfg, qb) for p in members]

    graphs = load_data(args.dataset, args.data_root)
    stage = prepare_stage_data(cfg, graphs, name=args.dataset,
                               need_truth=True)

    # ONE forward + clamp (budget-independent), then sweep only the
    # verification pass so per-budget wall-clock isolates the knob
    base_cfg = dataclasses.replace(cfg, verify_budget=0.0)
    t0 = time.perf_counter()
    raw, _ = neighborhood_predictions(members, tgt_cfg, embs, stage,
                                      base_cfg, device)
    forward_s = time.perf_counter() - t0

    log(f"device: {device_label(device)}")
    log(f"{args.dataset}: {len(graphs)} graphs, "
        f"{raw.shape[0]} neighborhoods")
    log(f"{'budget':>8} {'rows verified':>14} {'verify s':>9} "
        f"  normed MSE q3 / q4 / q5")
    rows = []
    for b in args.budgets:
        if b > 0:
            c = dataclasses.replace(cfg, verify_budget=b)
            t0 = time.perf_counter()
            counts, verified = verify_tail_counts(raw.copy(), stage, c)
            dt = time.perf_counter() - t0
        else:
            counts, verified, dt = raw, np.zeros(0, np.int64), 0.0
        res = evaluate_graphlet_counts(cfg, stage, counts)
        nm = res["norm_mse_neighborhood"]
        log(f"{b:>8g} {len(verified):>14} {dt:>9.1f}   "
            + " / ".join(f"{v:.3e}" for v in nm))
        rows.append({"budget": b, "rows_verified": len(verified),
                     "verify_s": dt, "norm_mse": list(nm),
                     "counts": counts})
    return {"device": device_label(device), "graphs": len(graphs),
            "neighborhoods": int(raw.shape[0]), "forward_s": forward_s,
            "rows": rows}


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
