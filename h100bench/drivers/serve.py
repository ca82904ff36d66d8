"""Serving: a closed loop of one client over ``CountingService.count_stream``.

Set-up draws the mix's pool of graphs from the Syn_1827 grid (from the
mix's ``graph_seed``: the same graphs for every run), cut into requests
of ``graphs_per_request`` graphs (``request_groups``), takes the weights (the configuration's trained
checkpoint, or made from the seed), writes them as checkpoints under
TMPDIR, loads the service, and serves every request once (every
capacity bucket pinned, every forward captured), then more until a pass
captures nothing. The window offers the requests in ``--seed``'s order,
again and again, each as fresh graph objects, through one ``count_stream``
(the decomposition runs in the window on its producer thread); a request
is timed from when the stream takes it to when its result comes back.
After the window every offered request is drained.

Correctness: a sample of the completed requests, drawn from the seed and
holding the one with the most nodes, is served again by the plain
reference, and the program's stage-1 counts, node counts and graph
counts are held against it (``compare``).
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

from ..gen import syn1827
from ..lib import flops as fl
from ..lib import harness
from ..lib import weights as wt
from ..lib.context import Context
from ..lib.trace import Recorder, breakdown, device_profile
from ..reference import pipeline as ref


def _graph(Graph, n: int, edges: np.ndarray):
    return Graph(n, edges.copy())


def graph_counts(node: np.ndarray, sizes) -> np.ndarray:
    """[graphs, Q] graph counts as the service returns them: each graph's
    node counts summed, at least 0, rounded to the nearest whole."""
    return np.round(np.maximum(_per_graph(node, sizes), 0.0))


def _per_graph(rows: np.ndarray, sizes) -> np.ndarray:
    out = np.zeros((len(sizes), rows.shape[1]), dtype=np.float64)
    np.add.at(out, np.repeat(np.arange(len(sizes)), sizes), rows)
    return out


def compare(stage1: np.ndarray, node: np.ndarray, graph: np.ndarray,
            sizes, ref_own: dict, ref_follow: dict,
            node_limit: float) -> Dict[str, float]:
    """The numbers held against their limits, each a gap over the size of
    what the compared value was summed from (the reference's), so that
    float32 rounding reads alike however large the activations grow.

    ``stage1_gap``: the widest gap between the program's and the
    reference's stage-1 counts (clamped, before gossip), over 1 + the
    reference's |count| and over 1 + the size of its prediction (a count
    is 2^pred - 1, so the first division leaves at most ln 2 times the
    gap of the prediction), over every neighborhood and query.
    ``node_gap``: the widest gap between the served node counts and the
    reference's gossip stage and node clamp run on the program's stage-1
    counts (``ref_follow``), over 1 + the size of the count (|stage-1
    count| + the absolute terms of the residual's last product).
    ``graph_gap``: the widest gap between a served graph count (``graph``,
    one row per graph of ``sizes`` nodes) and the counts that node counts
    within ``node_limit`` of the reference's would give, over 1 + the
    count: the service sums a graph's node counts, takes at least 0 and
    rounds, so a sound count lies between the roundings of the
    reference's sum less and plus ``node_limit`` x the sum of the
    nodes' 1 + scale, and reads 0. Every graph and query is compared."""
    if (stage1.shape != ref_own["stage1"].shape
            or node.shape != ref_follow["node"].shape
            or graph.shape != (len(sizes), node.shape[1])):
        return {"stage1_gap": float("inf"), "node_gap": float("inf"),
                "graph_gap": float("inf")}
    r1 = ref_own["stage1"]
    total = _per_graph(ref_follow["node"], sizes)
    room = (node_limit * _per_graph(1.0 + ref_follow["scale"], sizes)
            + 1e-9 * (1.0 + np.abs(total)))
    lo = np.round(np.maximum(total - room, 0.0))
    hi = np.round(np.maximum(total + room, 0.0))
    out = np.maximum(lo - graph, 0.0) + np.maximum(graph - hi, 0.0)
    return {
        "stage1_gap": float((np.abs(stage1 - r1) / (1.0 + np.abs(r1))
                             / (1.0 + ref_own["stage1_scale"])).max()),
        "node_gap": float((np.abs(node - ref_follow["node"])
                           / (1.0 + ref_follow["scale"])).max()),
        "graph_gap": float((out / (1.0 + np.abs(total))).max()),
    }


def request_groups(sids: List[int], per: int) -> List[List[int]]:
    """The pool cut into requests of ``per`` grid ids, the same for every
    seed: ``len(sids) // per`` groups, group k the ids k, k + G, k + 2G,
    ... of the sorted ids (G groups), so each request holds every size
    stratum of the grid alike; the ids left over are not served."""
    sids = sorted(sids)
    n = len(sids) // per
    return [sids[k::n][:per] for k in range(n)]


def serve_weights(cfg: dict, seed: int, device):
    """(neighborhood, gossip) weights: the configuration's trained
    checkpoint where it names one (``serve_weights``), else made from the
    seed."""
    if cfg.get("serve_weights"):
        return tuple(wt.load_weights(os.path.join(
            harness.REPO_DIR, cfg["serve_weights"], part + ".params.npz"),
            device) for part in ("neigh", "gossip"))
    return (wt.make_weights(wt.neighborhood_specs(cfg), seed, 0, device),
            wt.make_weights(wt.gossip_specs(cfg), seed, 1, device))


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, build_dir: str) -> dict:
    """One run of the cell. Besides the result, ``reference`` holds what
    the check compared: the reference's inputs and run, and the
    program's answers."""
    import torch

    from desco_tpu_torch import pipeline, serving
    from desco_tpu_torch.graph import Graph
    from desco_tpu_torch.parallel import dp

    t0 = time.perf_counter()
    lo_n, hi_n = traffic["grid_nodes"]
    per = traffic["graphs_per_request"]
    groups = request_groups(
        syn1827.grid_ids(lo_n, hi_n)[:traffic.get("pool_limit")], per)
    pool = syn1827.make_graphs([sid for g in groups for sid in g],
                               traffic["graph_seed"])
    t_graphs = time.perf_counter() - t0

    w_neigh, w_gossip = serve_weights(cfg, seed, device)
    tmp = tempfile.mkdtemp(prefix="h100bench-", dir=os.environ.get("TMPDIR"))
    try:
        pcfg = wt.pipeline_config(cfg)
        wt.save_checkpoint(os.path.join(tmp, "neigh"), w_neigh, pcfg)
        wt.save_checkpoint(os.path.join(tmp, "gossip"), w_gossip, pcfg)
        t1 = time.perf_counter()
        svc = serving.CountingService(
            os.path.join(tmp, "neigh"), os.path.join(tmp, "gossip"),
            config_overrides=traffic["service"], compile_cache=build_dir,
            device=str(device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t_load = time.perf_counter() - t1

    order = np.random.default_rng(
        [int(seed) & (2**63 - 1), 11]).permutation(len(groups))

    def request(i: int, seeded: bool = True) -> List[int]:
        """The pool indices of request ``i``: the groups in the seed's
        order (set-up: in their own order), again and again."""
        g = int(order[i % len(groups)]) if seeded else i % len(groups)
        return list(range(g * per, (g + 1) * per))

    # set-up: every request once, then passes until nothing is captured,
    # in the same order for every seed (a service pins a bucket's
    # capacities at the first request that needs them)
    t2 = time.perf_counter()
    n_warm = len(groups)
    for _ in svc.count_stream(
            ([_graph(Graph, *pool[g]) for g in request(i, False)]
             for i in range(n_warm)), prefetch=traffic["prefetch"]):
        pass
    extra = traffic.get("warm_check_requests", 4)
    for _ in range(traffic.get("warm_passes_max", 4)):
        before = svc.graphs.stats()["captures"]
        for _ in svc.count_stream(
                ([_graph(Graph, *pool[g]) for g in request(n_warm + i, False)]
                 for i in range(extra)), prefetch=traffic["prefetch"]):
            pass
        n_warm += extra
        if svc.graphs.stats()["captures"] == before:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_warm = time.perf_counter() - t2
    setup_s = time.perf_counter() - t_start
    captures_before = svc.graphs.stats()["captures"]

    rec = Recorder()
    undo = []
    if trace:
        def stage_info(a, k, out):
            return {"shapes": [fl.batch_shape(b.node_mask, b.graph_mask,
                                              b.edge_dst, b.edge_type, 6)
                               for b in out.batches],
                    "graphs": len(a[1])}

        def gossip_info(a, k, out):
            return {"shapes": [fl.batch_shape(b.node_mask, b.graph_mask,
                                              b.edge_dst, b.edge_type, 2)
                               for b in out]}

        undo = [
            rec.wrap(serving, "prepare_stage_data", "prepare", stage_info),
            rec.wrap(dp, "dp_predict_neighborhood_counts",
                     "neighborhood_forward"),
            rec.wrap(pipeline, "stage_bounds", "bounds"),
            rec.wrap(serving, "prepare_gossip_batches", "gossip_pack",
                     gossip_info),
            rec.wrap(serving, "dp_predict_gossip_counts", "gossip_forward"),
            rec.wrap(serving.CountingService, "_guard_and_package",
                     "guards"),
        ]
    window = min(seconds, traffic.get("trace_seconds", seconds)) \
        if trace else seconds
    offered, done, results = [], [], []
    clock = {}

    def stream():
        i = n_warm
        while time.perf_counter() < clock["end"]:
            gs = request(i)
            reqs.append(gs)
            offered.append(time.perf_counter())
            yield [_graph(Graph, *pool[g]) for g in gs]
            i += 1

    reqs: List[List[int]] = []
    try:
        with device_profile(trace, device.type) as prof:
            # the window opens once the profiler runs
            start = time.perf_counter()
            end = clock["end"] = start + window
            start_ns = time.time_ns()
            try:
                for res in svc.count_stream(stream(),
                                            prefetch=traffic["prefetch"]):
                    done.append(time.perf_counter())
                    results.append(res)
            except Exception as exc:  # what never came back is failed
                print(f"serving failed: {exc!r}", file=sys.stderr,
                      flush=True)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            hi_ns = time.time_ns()
    finally:
        for u in undo:
            u()
    captures_window = svc.graphs.stats()["captures"] - captures_before

    n_done = len(done)
    failed = len(offered) - n_done
    lat_ms = np.array([(d - o) * 1e3 for o, d in zip(offered, done)])
    in_window = [i for i, d in enumerate(done) if d <= end]
    graphs_in_window = sum(len(reqs[i]) for i in in_window)
    metrics = {
        "setup_s": setup_s,
        "serve_graphs_per_s": graphs_in_window / window,
        # a request that failed counts as missing any limit
        "serve_p95_ms": (float(np.percentile(
            np.concatenate([lat_ms, np.full(failed, np.inf)]), 95))
            if len(offered) else float("inf")),
    }
    diag = {"requests": len(offered), "completed": n_done,
            "captures_in_window": captures_window,
            "latency_p50_ms": float(np.median(lat_ms)) if n_done else None,
            "setup_parts_s": {"graphs": t_graphs, "load": t_load,
                              "warm": t_warm}}

    ctx = None
    if trace and prof:
        ctx = Context(cfg, traffic, prof[0], rec.spans, start_ns, hi_ns,
                      {"graphs": float(sum(len(r) for r in reqs[:n_done])),
                       "requests": float(n_done),
                       "queries": float(len(pipeline.pipeline_queries(
                           svc.cfg)))},
                      fl.peaks(), {})
        consumer = {s.thread for s in rec.spans if s.name == "bounds"}
        ctx.counters["breakdown"] = breakdown(prof[0], rec.spans, start_ns,
                                              hi_ns, consumer)

    # the service's state is freed before the reference runs
    del svc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = {"stage1_gap": float("inf"), "node_gap": float("inf"),
               "graph_gap": float("inf")}
    checked = None
    if n_done and not failed:
        rng = np.random.default_rng([int(seed) & (2**63 - 1), 13])
        k = min(traffic["check_requests"], n_done)
        sizes = [sum(pool[g][0] for g in reqs[i]) for i in range(n_done)]
        biggest = int(np.argmax(sizes))
        rest = [i for i in range(n_done) if i != biggest]
        pick = sorted([biggest] + list(rng.choice(rest, k - 1,
                                                  replace=False))
                      if k > 1 else [biggest])
        graphs = [pool[g] for i in pick for g in reqs[i]]
        prog = {"stage1": np.concatenate([results[i].neighborhood_counts
                                          for i in pick]),
                "node": np.concatenate([results[i].node_counts
                                        for i in pick]),
                "graph": np.concatenate([results[i].graphlet_counts
                                         for i in pick])}
        args = (graphs, w_neigh, w_gossip, cfg["conv_type"], cfg["depth"],
                device)
        ref_out = ref.serve(*args, gossip_input=prog["stage1"])
        node_limit = harness.limits(cell["name"])["node_gap"]
        sizes = [n for n, _ in graphs]
        numbers = compare(prog["stage1"], prog["node"], prog["graph"], sizes,
                          ref_out, ref_out, node_limit)
        diag["checked_requests"] = len(pick)
        checked = {"args": args, "ref_out": ref_out, "prog": prog,
                   "sizes": sizes, "node_limit": node_limit}
    return {"metrics": metrics, "numbers": numbers,
            "attempted": len(offered), "failed": failed,
            "context": ctx, "memory_peak_bytes": peak, "diagnostics": diag,
            "reference": checked}
