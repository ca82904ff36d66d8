"""End-to-end serving throughput: graphs in -> graphlet counts out.

    python -m desco_tpu_torch.tools.serving_bench [--graphs 64] [--min 30]
        [--max 120] [--verify 0.001] [--device cpu]
        [--mode raw|service|stream|latency]

The port of desco_tpu's ``analysis/serving_bench.py``, with its flags,
defaults and printed lines (``--platform`` is ``--device``: the card by
default; ``--device cpu`` runs on the CPU). It measures the FULL
inference pipeline on fresh synthetic graphs (no caches): canonical
decomposition + triangle typing + packing (host), stage-1 SHMP
prediction (device), combinatorial clamp + optional exact tail
verification, gossip refinement (device), graph-level aggregation, and
reports per-phase seconds and one graphs/s / nodes/s summary.

Modes: ``raw`` drives the pipeline functions directly; ``service`` drives
the public ``CountingService.count`` API (``--n_devices`` serves over
that many data-parallel replicas); ``stream`` drives ``count_stream``
(host prep of request k+1 overlaps device compute of request k) against
sequential ``count`` calls; ``latency`` reports warm single-graph
p50/p90/p99 via ``count_graph``. Each run builds its own service: a
service that has served 64-graph requests packs single graphs into that
pinned bucket. Pass --neigh_ckpt (one path, or several for an ensemble)
/ --gossip_ckpt to bench trained weights; the default is random
initialization from ``torch.Generator``s seeded 0 and 1 (throughput does
not depend on the weights).

Every window's results are read back to the host (the pipeline returns
numpy arrays), so the seconds are device work done, not work enqueued.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.tools.serving_bench")
    ap.add_argument("--graphs", type=int, default=64)
    ap.add_argument("--min", type=int, default=30)
    ap.add_argument("--max", type=int, default=120)
    ap.add_argument("--verify", type=float, default=0.001)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--mode", default="raw",
                    choices=["raw", "service", "stream", "latency"])
    ap.add_argument("--requests", type=int, default=8,
                    help="stream mode: number of --graphs-sized requests")
    ap.add_argument("--neigh_ckpt", default=None, nargs="+",
                    help="one path, or several for a serving ensemble")
    ap.add_argument("--gossip_ckpt", default=None)
    ap.add_argument("--n_devices", type=int, default=1,
                    help="service modes: DP-serve over this many devices")
    ap.add_argument("--exact_size", type=int, default=0,
                    help="recount queries with <= N nodes exactly "
                         "(serving knob; measures its cost)")
    return ap


def random_weights(cfg):
    """(neighborhood, gossip) parameters of ``cfg``'s widths drawn from
    ``torch.Generator``s seeded 0 and 1, on the CPU."""
    import torch

    from ..models import gossip as gossip_mod
    from ..models import neighborhood as neigh_mod
    from ..pipeline import model_configs

    tgt, qry = model_configs(cfg, torch.device("cpu"))
    params = neigh_mod.init_neighborhood_model(
        tgt, qry, torch.Generator().manual_seed(0))
    gparams = gossip_mod.init_gossip_model(
        input_dim=1, hidden_dim=cfg.gossip_hidden_dim,
        emb_channels=cfg.neigh_hidden_dim, layer_num=cfg.gossip_layer_num,
        generator=torch.Generator().manual_seed(1))
    return params, gparams


def run(args, weights=None, log=print) -> dict:
    """Run one mode; returns its numbers. ``weights`` ((neighborhood,
    gossip) parameter modules) replace the raw mode's random ones."""
    from ..data.synthetic import generate_synthetic
    from ..utils.device import device_label, resolve_device

    device = resolve_device(args.device)
    graphs = generate_synthetic(args.graphs, min_size=args.min,
                                max_size=args.max, seed=args.seed)
    n_nodes = sum(g.n_nodes for g in graphs)
    n_edges = sum(g.n_edges for g in graphs)
    log(f"device: {device_label(device)}")
    log(f"{len(graphs)} graphs, {n_nodes} nodes, {n_edges} edges")
    out = {"device": device_label(device), "mode": args.mode,
           "graphs": len(graphs), "nodes": n_nodes, "edges": n_edges}
    if args.mode == "raw":
        out.update(_raw(args, graphs, n_nodes, device, weights, log))
    else:
        out.update(_service_modes(args, graphs, n_nodes, device, log))
    return out


def _raw(args, graphs, n_nodes: int, device, weights, log) -> dict:
    import torch

    from ..models import neighborhood as neigh_mod
    from ..pipeline import (
        PipelineConfig, build_query_batch, model_configs,
        neighborhood_predictions, prepare_gossip_batches,
        prepare_stage_data)
    from ..train.loop import predict_gossip_counts

    cfg = PipelineConfig(
        data_root=tempfile.mkdtemp(prefix="serve_bench_"),
        clamp_counts=True, verify_budget=args.verify)
    tgt_cfg, qry_cfg = model_configs(cfg, device)
    qb = build_query_batch(cfg).to(device)
    params, gparams = weights or random_weights(cfg)
    params, gparams = params.to(device), gparams.to(device)

    def embed():
        with torch.inference_mode():
            return neigh_mod.embed_queries(params, qry_cfg, qb)

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    # need_truth=False: serving has no labels, only decomposition,
    # typing, packing
    stage = prepare_stage_data(cfg, graphs, name="serve_bench",
                               need_truth=False)
    t_host = time.perf_counter() - t0

    t0 = time.perf_counter()
    counts, _ = neighborhood_predictions(
        params, tgt_cfg, embed(), stage, cfg, device)
    t_stage1 = time.perf_counter() - t0

    t0 = time.perf_counter()
    gb = prepare_gossip_batches(cfg, stage, counts)
    query_embs = embed()
    node_counts = predict_gossip_counts(gparams, query_embs, gb, device)
    graphlet = stage.workload.aggregate_node_counts(node_counts)
    t_gossip = time.perf_counter() - t0
    dt = time.perf_counter() - t_all

    # warm pass: the same shapes; steady-state serving runs at this rate
    t0 = time.perf_counter()
    counts, _ = neighborhood_predictions(
        params, tgt_cfg, embed(), stage, cfg, device)
    w_stage1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    gb = prepare_gossip_batches(cfg, stage, counts)
    node_counts = predict_gossip_counts(gparams, query_embs, gb, device)
    graphlet = stage.workload.aggregate_node_counts(node_counts)
    w_gossip = time.perf_counter() - t0
    w_total = t_host + w_stage1 + w_gossip

    log(f"host decompose+pack: {t_host:.2f}s")
    log(f"stage-1 predict+clamp+verify: cold {t_stage1:.2f}s / "
        f"warm {w_stage1:.2f}s")
    log(f"gossip refine+aggregate: cold {t_gossip:.2f}s / "
        f"warm {w_gossip:.2f}s")
    log(f"COLD  {dt:.2f}s -> {len(graphs) / dt:.1f} graphs/s")
    log(f"WARM  {w_total:.2f}s -> {len(graphs) / w_total:.1f} graphs/s, "
        f"{n_nodes / w_total:.0f} nodes/s "
        f"(graphlet shape {graphlet.shape})")
    return {"host_s": t_host, "stage1_s": [t_stage1, w_stage1],
            "gossip_s": [t_gossip, w_gossip], "cold_s": dt,
            "warm_s": w_total, "graphs_per_s": len(graphs) / w_total,
            "nodes_per_s": n_nodes / w_total, "graphlet_counts": graphlet}


def _service_modes(args, graphs, n_nodes: int, device, log) -> dict:
    """service / stream / latency modes over the public API."""
    from ..data.synthetic import generate_synthetic
    from ..pipeline import PipelineConfig
    from ..serving import CountingService
    from ..train.checkpoint import save_checkpoint

    cfg = PipelineConfig(
        data_root=tempfile.mkdtemp(prefix="serve_bench_"),
        clamp_counts=True, verify_budget=args.verify)
    np_path, gp_path = args.neigh_ckpt, args.gossip_ckpt
    if isinstance(np_path, list) and len(np_path) == 1:
        np_path = np_path[0]
    if np_path is None:
        params, gparams = random_weights(cfg)
        root = tempfile.mkdtemp(prefix="serve_bench_ckpt_")
        np_path, gp_path = root + "/neigh", root + "/gossip"
        blob = dataclasses.asdict(cfg)
        save_checkpoint(np_path, params, config=blob)
        save_checkpoint(gp_path, gparams, config=blob)
    svc = CountingService(
        np_path, gp_path, n_devices=args.n_devices, device=device,
        config_overrides={"verify_budget": args.verify,
                          "exact_size": args.exact_size,
                          "data_root": cfg.data_root})

    # warm-up: build, then pin capacities on a representative request
    t0 = time.perf_counter()
    svc.count(graphs)
    cold = time.perf_counter() - t0
    log(f"cold first request: {cold:.2f}s")
    out = {"cold_s": cold}

    if args.mode == "service":
        t0 = time.perf_counter()
        res = svc.count(graphs)
        dt = time.perf_counter() - t0
        log(f"WARM service.count  {dt:.2f}s -> "
            f"{len(graphs) / dt:.1f} graphs/s, {n_nodes / dt:.0f} "
            f"nodes/s (graphlet shape {res.graphlet_counts.shape})")
        out.update(warm_s=dt, graphs_per_s=len(graphs) / dt,
                   nodes_per_s=n_nodes / dt, result=res)
    elif args.mode == "stream":
        reqs = [generate_synthetic(args.graphs, min_size=args.min,
                                   max_size=args.max, seed=args.seed + i)
                for i in range(args.requests)]
        total_g = sum(len(r) for r in reqs)
        total_n = sum(g.n_nodes for r in reqs for g in r)
        # sequential per-request calls vs the pipelined stream
        t0 = time.perf_counter()
        seq_res = [svc.count(r) for r in reqs]
        seq = time.perf_counter() - t0
        t0 = time.perf_counter()
        streamed = list(svc.count_stream(reqs, prefetch=2))
        pipe = time.perf_counter() - t0
        if len(streamed) != len(reqs):
            raise RuntimeError(f"count_stream answered {len(streamed)} of "
                               f"{len(reqs)} requests")
        log(f"sequential {seq:.2f}s ({total_g / seq:.1f} graphs/s) | "
            f"pipelined {pipe:.2f}s ({total_g / pipe:.1f} graphs/s, "
            f"{total_n / pipe:.0f} nodes/s) | overlap gain "
            f"{seq / pipe:.2f}x")
        out.update(sequential_s=seq, pipelined_s=pipe,
                   graphs_per_s=total_g / pipe, nodes_per_s=total_n / pipe,
                   overlap_gain=seq / pipe, results=streamed,
                   sequential_results=seq_res)
    else:  # latency
        # warm every capacity bucket these singles land in (one pinned
        # bucket per pow2 graph count, a one-time cost in steady state)
        for g in graphs:
            svc.count_graph(g)
        lat = []
        for g in graphs:
            t0 = time.perf_counter()
            svc.count_graph(g)
            lat.append(time.perf_counter() - t0)
        lat_ms = np.sort(np.asarray(lat) * 1e3)
        pct = {p: float(np.percentile(lat_ms, p)) for p in (50, 90, 99)}
        log(f"single-graph latency over {len(lat_ms)} graphs: "
            f"p50 {pct[50]:.1f}ms  p90 {pct[90]:.1f}ms  "
            f"p99 {pct[99]:.1f}ms  "
            f"(min {lat_ms[0]:.1f}, max {lat_ms[-1]:.1f})")
        out.update(latency_ms=pct, min_ms=float(lat_ms[0]),
                   max_ms=float(lat_ms[-1]))
    return out


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
