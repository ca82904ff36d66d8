"""Scaling efficiency of the halo-partitioned SHMP forward over 1..D shards.

    python -m desco_tpu_torch.tools.scaling --graph comm --locality bfs
        [--devices 1 2 4 8] [--device cpu] [--json out.json]

The port of desco_tpu's ``analysis/scaling.py``, with its flags, graphs
and printed lines (``--platform`` is ``--device``: the card by default).
The graph is partitioned over D shards (``parallel/halo.py``), placed
with ``halo.shard_devices(D, device)`` and run through
``halo_shmp_core``: per layer the pull / push exchanges and the shards'
sums (the gather-fused K1 on the card). Two efficiencies per D:

  * strong: eps(D) / (D * eps(1)). It means something only where each
    shard has its own card. The shards cycle over the visible cards, so
    on ONE card (or on the CPU) all D shards share it and the same work
    runs in turn: strong efficiency is bounded by that, not by the halo
    design. The tool says so when shards share a device.
  * comm: T_control(D) / T_halo(D), where the control is the same
    partition with cross-shard edges dropped (``drop_cross=True``): a
    workload of the same shapes without communication. This isolates
    what the halo design controls (exchange volume and count) and is
    the number to read on one card.

Graph families: er / ba are expanders (any balanced D-cut severs a
constant share of the edges); rgg / comm have geometric or community
locality that the ordering + contiguous cuts turn into small boundary
sets. ``er`` and ``comm`` draw desco_tpu's numpy stream; ``ba`` and
``rgg`` are networkx's generators as ``data/nx_subset.py`` copies them.

Each time is the median of three windows, each of enough forwards for
half a second, and each window ends with a synchronize (the CUDA queue
drained), so it times device work done, not work enqueued.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_graph(kind: str, n: int, degree: int, rng):
    """desco_tpu's scaling graphs: a sorted (u < v) int32 edge array."""
    from ..data import nx_subset

    if kind == "ba":
        g = nx_subset.barabasi_albert_graph(n, max(1, degree // 2), seed=0)
        return np.array(sorted(g.edges()), np.int32)
    if kind == "rgg":
        # random geometric graph: radius tuned for ~degree mean
        r = (degree / (np.pi * n)) ** 0.5
        g = nx_subset.random_geometric_graph(n, r, seed=0)
        return np.array(sorted(g.edges()), np.int32)
    if kind == "comm":
        # 8 ER communities, 1% of edges cross-community
        k = 8
        per = n // k
        m_in = n * degree // 2
        edges = set()
        while len(edges) < m_in:
            c = rng.integers(k)
            u, v = c * per + rng.integers(0, per, 2)
            if u != v:
                edges.add((min(u, v), max(u, v)))
        m_x = m_in // 100
        while len(edges) < m_in + m_x:
            u, v = rng.integers(0, n, 2)
            if u != v and u // per != v // per:
                edges.add((min(u, v), max(u, v)))
        return np.array(sorted(edges), np.int32)
    # er
    m = n * degree // 2
    e = set()
    while len(e) < m:
        u, v = rng.integers(0, n, 2)
        if u != v:
            e.add((min(u, v), max(u, v)))
    return np.array(sorted(e), np.int32)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.tools.scaling")
    p.add_argument("--nodes", type=int, default=20000)
    p.add_argument("--degree", type=int, default=8)
    p.add_argument("--graph", type=str, default="er",
                   choices=["er", "ba", "rgg", "comm"],
                   help="er: uniform random; ba: preferential attachment "
                        "(hub skew); rgg: random geometric (spatial "
                        "locality); comm: 8 ER communities w/ 1%% cross")
    p.add_argument("--locality", type=str, default="metis",
                   choices=["none", "bfs", "metis"],
                   help="node reordering before contiguous cuts: "
                        "multilevel coarsening (metis, recovers "
                        "communities) or BFS")
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="shard counts D")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--device", type=str, default=None,
                   help="torch device the shards cycle over (default: "
                        "every visible CUDA card)")
    p.add_argument("--json", type=str, default=None,
                   help="write the per-D results as a JSON artifact")
    return p


def typed_graph(args, rng):
    """(n, node_type, x, edge_src, edge_dst, edge_type, n_edges): the
    graph as one whole-graph typed sample, locality-ordered."""
    from ..batch.build import neighborhood_sample
    from ..graph.canonical import Neighborhood
    from ..graph.container import Graph
    from ..parallel.halo import locality_order

    n = args.nodes
    raw = build_graph(args.graph, n, args.degree, rng)
    # permute node ids: generators emit structured orders (communities
    # contiguous, BA hubs first) that no real input guarantees; the
    # locality step must earn its cut, not inherit it
    pm = rng.permutation(n).astype(np.int32)
    g = Graph(n, pm[raw])
    nb = Neighborhood(graph=g, canonical=n - 1,
                      nodes=np.arange(n, dtype=np.int32))
    s = neighborhood_sample(nb)
    node_type, x = s.node_type, s.x
    e_src, e_dst, e_ty = s.edge_src, s.edge_dst, s.edge_type
    if args.locality != "none":
        order = locality_order(n, e_src, e_dst, method=args.locality)
        inv = np.empty_like(order)
        inv[order] = np.arange(n)
        node_type, x = node_type[order], x[order]
        e_src, e_dst = inv[e_src].astype(np.int32), inv[e_dst].astype(
            np.int32)
    return n, node_type, x, e_src, e_dst, e_ty, s.n_edges


def run(args, params=None, log=print) -> dict:
    """Returns one row per D (ms per forward, edge-layers/s, the two
    efficiencies, pull and push per pair) and each D's output in global
    node order (``out``). ``params`` (an SHMP tower of the config's
    widths) replaces the fresh one drawn from seed 0."""
    import torch

    from ..models.shmp_gnn import init_shmp, neighborhood_target_config
    from ..parallel import halo
    from ..utils.device import device_label, resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    n, node_type, x, e_src, e_dst, e_ty, n_edges = typed_graph(args, rng)
    cfg = neighborhood_target_config(layer_num=args.layers,
                                     hidden_dim=args.hidden)
    if params is None:
        params = init_shmp(cfg, torch.Generator().manual_seed(0))
    params = params.to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def timed(shards):
        def f():
            return halo.halo_shmp_core(params, cfg, shards)
        out = f()
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            f()
        sync()
        per = (time.perf_counter() - t0) / args.reps
        n_iters = max(args.reps, int(0.5 / max(per, 1e-6)))
        reps3 = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n_iters):
                f()
            sync()
            reps3.append((time.perf_counter() - t0) / n_iters)
        return sorted(reps3)[1], out

    log(f"device: {device_label(device)}")
    results, rows, outs = {}, [], {}
    noted = False
    for d in args.devices:
        devices = halo.shard_devices(d, device)
        if len(set(devices)) < d and not noted:
            log(f"{d} shards share {len(set(devices))} device(s): the "
                f"shards run in turn, so strong efficiency is bounded "
                f"by that; read comm")
            noted = True
        part = halo.partition_typed_graph(
            n, node_type, x, e_src, e_dst, e_ty, d,
            n_types=cfg.n_edge_types)
        ctrl = halo.partition_typed_graph(
            n, node_type, x, e_src, e_dst, e_ty, d,
            n_types=cfg.n_edge_types, drop_cross=True)
        with torch.inference_mode():
            dt, out = timed(halo.place_shards(part, devices))
            dt_ctrl = (timed(halo.place_shards(ctrl, devices))[0]
                       if d > 1 else dt)
            outs[d] = halo.unpartition_nodes(
                part, np.stack([o.float().cpu().numpy() for o in out]))
        eps = n_edges * args.layers / dt
        results[d] = eps
        base = results[min(results)]
        strong = eps / (base * d / min(results))
        comm = dt_ctrl / dt
        log(f"D={d}: {dt * 1e3:8.2f} ms/fwd  {eps / 1e6:8.1f}M "
            f"edge-layers/s  strong {strong * 100:5.1f}%  "
            f"comm {comm * 100:5.1f}%  (ctrl {dt_ctrl * 1e3:.2f} ms, "
            f"pull/pair {part.h_max}, push/pair {part.p_max})")
        rows.append(dict(d=d, ms_fwd=dt * 1e3, edge_layers_per_s=eps,
                         strong=strong, comm=comm,
                         ctrl_ms=dt_ctrl * 1e3, pull_pair=int(part.h_max),
                         push_pair=int(part.p_max)))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(
                graph=args.graph, nodes=args.nodes, degree=args.degree,
                locality=args.locality, hidden=args.hidden,
                layers=args.layers, device=device_label(device),
                results=rows), f, indent=1)
        log(f"wrote {args.json}")
    return {"device": device_label(device), "n_edges": int(n_edges),
            "rows": rows, "out": outs}


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
