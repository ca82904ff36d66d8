"""Runtime probe: the neighborhood embedding forward on a dataset.

    python -m desco_tpu_torch.tools.runtime --dataset Syn_64
        [--trace output/runtime_trace] [--device cpu]

The port of desco_tpu's ``analysis/runtime.py``, with its flags and
printed line (and ``--device``: the card by default). It packs the
first ``--batch_size`` neighborhoods of the dataset into one batch and
times the 8-layer, width-64 SHMP target tower (``apply_shmp``, fresh
weights from seed 0; K2 and the pooling K1 on the card): ``--reps``
forwards per window, windows stretched to at least half a second, three
windows, the median, each window ending with a synchronize so that it
times device work done, not work enqueued. It reports valid edges per
second and graphs per second. ``--trace DIR`` writes a ``torch.profiler``
Chrome trace of the three windows to ``DIR/trace.json``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m desco_tpu_torch.tools.runtime")
    p.add_argument("--dataset", type=str, default="Syn_64")
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--trace", type=str, default=None,
                   help="torch.profiler trace output dir")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p


def runtime_batch(args):
    """The packed batch of the first ``batch_size`` neighborhoods."""
    from ..batch.packed import auto_capacities, pack_samples
    from ..data.datasets import load_data
    from ..data.workload import Workload

    graphs = load_data(args.dataset, args.data_root)
    wl = Workload(graphs, root=f"{args.data_root}/{args.dataset}",
                  name=args.dataset)
    samples, _ = wl.neighborhood_samples(
        args.depth, truth=np.zeros((wl.total_nodes, 2)))
    caps = auto_capacities(samples, g_cap=args.batch_size)
    return pack_samples(samples, *caps, n_queries=2)[0]


def run(args, params=None, log=print) -> dict:
    """Returns the median ms per forward, valid edges, graphs, the rates
    and the forward's output. ``params`` (an SHMP tower of the config's
    widths) replaces the fresh one drawn from seed 0."""
    import torch

    from ..models.shmp_gnn import (
        apply_shmp, init_shmp, neighborhood_target_config)
    from ..ops.cuda_segment import default_agg_mode
    from ..utils.device import device_label, resolve_device

    device = resolve_device(args.device)
    host_batch = runtime_batch(args)
    cfg = neighborhood_target_config(layer_num=8, hidden_dim=64,
                                     output_dim=64,
                                     agg_mode=default_agg_mode(device))
    if params is None:
        params = init_shmp(cfg, torch.Generator().manual_seed(0))
    params = params.to(device)
    batch = host_batch.to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    with torch.inference_mode():
        out = apply_shmp(params, cfg, batch)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            apply_shmp(params, cfg, batch)
        sync()
        per_iter = (time.perf_counter() - t0) / args.reps
        n_iters = max(args.reps, int(0.5 / max(per_iter, 1e-6)))

        prof = None
        if args.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n_iters):
                apply_shmp(params, cfg, batch)
            sync()
            windows.append((time.perf_counter() - t0) / n_iters)
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(args.trace, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.trace, "trace.json"))
            log(f"profile trace written to {args.trace}")

    node_mask = np.asarray(host_batch.node_mask)
    valid_edges = int((node_mask[np.asarray(host_batch.edge_src)] > 0).sum())
    n_graphs = int(np.asarray(host_batch.graph_mask).sum())
    t = float(np.median(windows))
    log(f"device: {device_label(device)}")
    log(f"emb_model forward: median {t * 1e3:.3f} ms "
        f"({n_iters} iters/window x 3)  "
        f"({valid_edges / t / 1e6:.1f}M edges/s, "
        f"{n_graphs / t:.0f} graphs/s)")
    return {"device": device_label(device), "ms": t * 1e3,
            "iters": n_iters, "valid_edges": valid_edges,
            "graphs": n_graphs, "edges_per_s": valid_edges / t,
            "graphs_per_s": n_graphs / t, "out": out.float().cpu().numpy()}


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
