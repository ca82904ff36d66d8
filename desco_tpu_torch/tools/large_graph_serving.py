"""Single-LARGE-graph end-to-end serving.

    python -m desco_tpu_torch.tools.large_graph_serving --nodes 20000 \\
        --devices 4 [--device cpu]

The port of desco_tpu's ``analysis/large_graph_serving.py``, with its
flags, graph and printed lines (``--platform`` is ``--device``: the card
by default). It serves ONE big graph (P2P / Astro scale) through
``CountingService.count_large_graph`` with fresh weights: the canonical
decomposition bounds stage 1's working set to depth-d neighborhoods
whatever the graph's size (packed batches), then the gossip refinement,
which must see the WHOLE graph, runs halo-sharded over ``--devices``
shards (``parallel/halo.serve_gossip_counts``: they cycle over the
visible cards, so on one card all of them share it), one pull / push
exchange per layer per query. Like the script it serves without clamp
and verification, and draws its weights from seeds 0 and 1
(``torch.Generator``s). A fresh service per run: one that has served
small requests packs the graph's neighborhoods into their pinned bucket.
The stage-1 line gives decomposition and forward as one figure, as the
service times them.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.tools.large_graph_serving")
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--degree", type=int, default=4)
    ap.add_argument("--devices", type=int, default=8,
                    help="halo shards of the gossip stage")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--query_sizes", type=int, nargs="+", default=[3])
    ap.add_argument("--seed", type=int, default=3)
    return ap


def ba_graph(n: int, degree: int, seed: int):
    """desco_tpu's large graph: BA-style preferential attachment, one
    big connected sparse graph."""
    from ..graph.container import Graph

    rng = np.random.default_rng(seed)
    pairs = set()
    for v in range(1, n):
        m = min(v, max(1, degree // 2))
        for t in set(rng.integers(0, v, m).tolist()):
            pairs.add((t, v))
    return Graph(n, np.array(sorted(pairs), np.int32))


def run(args, weights=None, log=print) -> dict:
    """Returns the stage seconds, the service's stats and the graphlet
    counts. ``weights`` ((neighborhood, gossip) parameter modules)
    replace the fresh ones."""
    from ..pipeline import PipelineConfig
    from ..serving import CountingService
    from ..train.checkpoint import save_checkpoint
    from ..utils.device import device_label, resolve_device
    from .serving_bench import random_weights

    device = resolve_device(args.device)
    g = ba_graph(args.nodes, args.degree, args.seed)
    n = g.n_nodes
    log(f"device: {device_label(device)}")
    log(f"graph: {n} nodes, {g.n_edges} undirected edges")

    cfg = PipelineConfig(query_sizes=tuple(args.query_sizes),
                         data_root=tempfile.mkdtemp(prefix="lgs_"),
                         clamp_counts=False, verify_budget=0.0)
    params, gparams = weights or random_weights(cfg)
    root = tempfile.mkdtemp(prefix="lgs_ckpt_")
    blob = dataclasses.asdict(cfg)
    save_checkpoint(root + "/neigh", params, config=blob)
    save_checkpoint(root + "/gossip", gparams, config=blob)
    svc = CountingService(root + "/neigh", root + "/gossip", device=device)

    stats: dict = {}
    t0 = time.perf_counter()
    res = svc.count_large_graph(g, n_devices=args.devices, stats=stats)
    wall = time.perf_counter() - t0
    s1, s2 = stats["stage1_s"], stats["partition_s"] + stats["gossip_s"]
    log(f"stage 1: {res.neighborhood_counts.shape[0]} neighborhoods, "
        f"prep+predict {s1:.1f}s ({stats['stage1_batches']} batches)")
    graphlet = np.maximum(np.round(res.node_counts), 0).sum(0)
    if not np.all(np.isfinite(graphlet)):
        raise RuntimeError("non-finite graphlet counts")
    log(f"stage 2 (halo, D={stats['n_devices']}): partition+predict "
        f"{s2:.1f}s (partition {stats['partition_s']:.2f}s, gossip "
        f"{stats['gossip_s']:.2f}s)")
    log(f"graphlet counts (first 5 queries): {graphlet[:5].tolist()}")
    log(f"TOTAL {wall:.1f}s — no device ever held more than "
        f"{stats['n_loc']}/{n} nodes in stage 2")
    return {"device": device_label(device), "nodes": n,
            "edges": g.n_edges, "wall_s": wall, **stats,
            "graphlet": graphlet, "result": res}


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
