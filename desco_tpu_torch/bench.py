"""Benchmark: SHMP neighborhood-model forward throughput on one GPU — the
port of the repo's root ``bench.py``.

    python -m desco_tpu_torch.bench [--dtype float32|bfloat16]
        [--hbm_gbps 3350] [--device cuda] [--eager]

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "edges/s", "vs_baseline": N, ...}

The workload is one packed batch of canonical neighborhoods (depth 4,
6-type tconv SHMP, 8 layers, hidden 64 — the paper config) driven through
the full counting forward (both embedding towers + the 29-query count
head), then through one full train step (forward + backward + Adam) on
the same batch. ``value`` counts *valid directed edges* per second of
steady-state forward. ``--dtype bfloat16`` switches the FORWARD's target
tower only (``serve_bf16`` semantics); the train step always runs the f32
config, as in ``bench.py``.

As the root ``bench.py`` times jitted functions, the forward and the
train step replay compiled ones (``utils/cuda_graphs.GraphedStep``, the
forward with ``inference``), each captured once as a CUDA graph with the
batch's streams and pooling offsets derived before; ``--eager`` runs
both eagerly instead (a comparison: such a run reads the baseline file
but never writes it).

Timing: warm up, calibrate the iteration count to a window of at least one
second, take the median of three windows; every window ends with
``torch.cuda.synchronize()``.

``vs_baseline`` compares with ``desco_tpu_torch/bench_baseline.json``
(written by the first run on a GPU if missing, with the card's name and
power limit and the dtype): above 1.0 means faster than that run. The
root ``bench_baseline.json`` belongs to desco_tpu and is neither read nor
written here.

The line also anchors the number to the card's memory rate:

  * ``bytes_per_edge_layer`` — the least device-memory traffic the port's
    kernel path must move per valid edge per layer (``_roofline_bytes``),
    per-node terms amortized over the edges;
  * ``sol_fraction`` — modeled traffic / forward time / memory rate: the
    share of the card's memory rate the forward sustains under that
    model. ``hbm_gbps_assumed`` is 3350 (H100 SXM data sheet) unless
    ``--hbm_gbps`` says otherwise;
  * ``graphs_per_s`` — whole neighborhoods per second of the same forward;
  * ``train_edges_per_s``, ``train_step_ms`` — the train step;
  * ``launches`` — kernel launches of ONE forward (K2 = 8: once per layer;
    a replay adds what its capture counted).

With ``--device cpu`` the same code runs on the kernels' plain versions
and prints ``"device": "cpu"``: such a line checks the script, it is no
measurement of the port, and the baseline file is neither read nor
written then. Without ``--device cpu`` and without a GPU the script
raises.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import time

import numpy as np

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "bench_baseline.json")
METRIC = "shmp_neighborhood_forward_edges_per_s_per_chip"
HBM_GBPS = 3350.0  # H100 SXM data sheet
N_QUERIES = 29
LAYERS, HIDDEN = 8, 64
# the workload's size and the timing windows (module constants so that a
# test can shrink them; the command line has no switch for them)
N_GRAPHS = 24
MIN_WINDOW_S = 1.0
MIN_ITERS = 30
MIN_TRAIN_ITERS = 10


def build_workload(n_graphs: int = 24, seed: int = 0, depth: int = 4,
                   device=None):
    """(batch, query_batch) as root ``bench.py:47-64`` builds them:
    ``n_graphs`` graphs of 30-120 nodes, every canonical neighborhood of
    depth ``depth``, the 29 queries of sizes 3-5 packed as one query
    batch, ``auto_capacities(samples, g_cap=512)`` and the FIRST packed
    batch, which carries ``edge_bwd_perm`` (the train step needs K3).

    The graphs come from the port's numpy generator
    (``data/synthetic.random_connected_graphs``, numpy seed ``seed``), as
    they have since the bench's baseline was recorded. Sizes and
    densities follow Syn_1827's samplers for its 30-120-node sample ids.

    With ``device`` the batches are torch tensors there (labels and the
    permutation kept); without, numpy on the host."""
    from .batch.build import neighborhood_sample, query_sample
    from .batch.packed import auto_capacities, pack_samples
    from .data.synthetic import random_connected_graphs
    from .graph.atlas import gen_queries, gen_query_ids
    from .graph.canonical import extract_all_neighborhoods

    graphs = random_connected_graphs(n_graphs, np.random.default_rng(seed))
    neighs, _, _ = extract_all_neighborhoods(graphs, depth=depth)
    samples = [neighborhood_sample(nb) for nb in neighs]
    qs = [query_sample(q) for q in gen_queries(gen_query_ids([3, 4, 5]))]
    [qb] = pack_samples(qs, *auto_capacities(qs, g_cap=len(qs)))
    caps = auto_capacities(samples, g_cap=512)
    batch = pack_samples(samples, *caps, n_queries=N_QUERIES)[0]
    if device is not None:
        batch, qb = batch.to(device, training=True), qb.to(device)
    return batch, qb


def _roofline_bytes(n_cap: int, e_cap: int, e_live: int, n_types: int,
                    h: int, layers: int, itemsize: int) -> int:
    """Least device-memory traffic (bytes) of the target tower's
    ``layers`` typed-aggregation layers on the port's kernel path
    (ops/cuda_segment.py, K2), per forward. ``itemsize`` is the tower's
    element size (4 for f32, 2 for bf16); K = h.

    per layer
      edge terms: the source of each LIVE edge (4 bytes; the kernel walks
        only the live runs) and the x row it gathers (h * itemsize). K2
        aggregates first and transforms in shared memory: no z and no
        [E, K] message tensor is written or read back.
      node terms: the (node, type) run offsets (4 * n_types), the f32
        output write (K * 4), and the update linear's reads (the f32 sums
        K * 4, x h * itemsize) and write (h * itemsize).

    Leaves out the query tower (a service runs it once per query set),
    the count head, the pre / post MLPs and the weights: a lower bound,
    so ``sol_fraction`` is conservative. ``e_cap`` (the slots, padding
    included) no longer enters it."""
    edge = e_live * (4 + h * itemsize)
    node = n_cap * (n_types * 4                # run offsets
                    + h * 4                    # K2's f32 output write
                    + h * 4 + h * itemsize     # update linear reads
                    + h * itemsize)            # update linear write
    return layers * (edge + node)


def _device_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[device.index or 0]


def timed_forward(forward, batch, qb, *, graphed: bool, capture: bool):
    """fwd() -> ``forward(batch, qb)``: the compiled forward
    (utils/cuda_graphs.GraphedStep with ``inference``, captured once as a
    CUDA graph where ``capture``, static buffers otherwise; it returns the
    static outputs), or with ``graphed=False`` the eager one, both under
    inference mode."""
    import torch

    from .utils.cuda_graphs import GraphedStep

    if not graphed:
        def fwd():
            with torch.inference_mode():
                return forward(batch, qb)
        return fwd
    compiled = GraphedStep(lambda xs: forward(*xs), (batch, qb),
                           capture=capture, inference=True)
    return lambda: compiled((batch, qb))


def timed_step(step_on, tb, state, generator, *, graphed: bool,
               capture: bool):
    """step() -> ``step_on(tb)``, which updates ``state`` in place: the
    compiled step (utils/cuda_graphs.GraphedStep), or with ``graphed=False``
    the eager one."""
    from .utils.cuda_graphs import GraphedStep

    if not graphed:
        return lambda: step_on(tb)
    compiled = GraphedStep(step_on, tb, capture=capture, state=state,
                           generators=[generator])
    return lambda: compiled(tb)


def _timed(fn, sync, min_iters: int, min_window_s: float):
    """(seconds of the median of three windows, iterations per window)."""
    fn()
    sync()  # first call: kernel build and load, allocator warm-up
    t0 = time.perf_counter()
    for _ in range(min(10, max(min_iters, 1))):
        fn()
    sync()
    per_iter = (time.perf_counter() - t0) / min(10, max(min_iters, 1))
    n_iters = max(min_iters, int(min_window_s / max(per_iter, 1e-6)))
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_iters):
            fn()
        sync()
        reps.append(time.perf_counter() - t0)
    return sorted(reps)[1], n_iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m desco_tpu_torch.bench")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32",
                    help="the forward's target tower (the train step is "
                         "always float32)")
    ap.add_argument("--hbm_gbps", type=float, default=HBM_GBPS,
                    help="device memory rate for sol_fraction, GB/s")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "GPU unless 'cpu' is given)")
    ap.add_argument("--eager", action="store_true",
                    help="run the forward and the train step eagerly "
                         "instead of replaying CUDA graphs")
    args = ap.parse_args(argv)

    import torch

    from .models import neighborhood as neigh_mod
    from .models.shmp_gnn import (
        neighborhood_target_config, prepare_batch, query_config)
    from .ops import cuda_segment as cs
    from .train import loop as train_loop
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    on_gpu = device.type == "cuda"

    def sync():
        if on_gpu:
            torch.cuda.synchronize(device)

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    agg_mode = cs.default_agg_mode(device)
    batch, qb = build_workload(n_graphs=N_GRAPHS, device=device)
    kw = dict(layer_num=LAYERS, hidden_dim=HIDDEN, output_dim=HIDDEN,
              agg_mode=agg_mode)
    train_cfg = neighborhood_target_config(**kw)
    tgt_cfg = dataclasses.replace(train_cfg, dtype=dtype)
    qry_cfg = query_config(layer_num=LAYERS, hidden_dim=HIDDEN,
                           output_dim=HIDDEN)
    params = neigh_mod.init_neighborhood_model(
        train_cfg, qry_cfg, torch.Generator().manual_seed(0)).to(device)
    train_params = copy.deepcopy(params)
    params.requires_grad_(False)

    # the train step's batch: the bench batch carries no labels, so attach
    # synthetic integer counts (shape and dtype of the real path)
    labels = np.random.default_rng(0).integers(
        0, 50, (batch.g_cap, N_QUERIES)).astype(np.float32)
    tb = dataclasses.replace(batch, y=torch.from_numpy(labels).to(device))
    # every batch's streams (forward and backward) and pooling offsets,
    # derived before the compiled forward and step are captured
    for b in (batch, tb):
        prepare_batch(b, train_cfg.n_edge_types, backward=True)
    prepare_batch(qb, qry_cfg.n_edge_types, backward=True)

    def forward(b, q):
        return neigh_mod.predict_counts(params, tgt_cfg, qry_cfg, b, q)

    fwd = timed_forward(forward, batch, qb, graphed=not args.eager,
                        capture=on_gpu)
    out = fwd()
    sync()
    if out.dtype != torch.float32 or not bool(
            torch.isfinite(out[batch.graph_mask > 0]).all()):
        raise RuntimeError("the forward's counts are not finite float32")
    cs.reset_launches()
    fwd()
    launches = {kern.__name__: kern.launches for kern in cs.KERNELS}
    if on_gpu and launches["fused_typed_transform_aggregate"] != LAYERS:
        raise RuntimeError(f"one forward launched K2 "
                           f"{launches['fused_typed_transform_aggregate']} "
                           f"times, not once per layer ({LAYERS})")

    dt, n_iters = _timed(fwd, sync, MIN_ITERS, MIN_WINDOW_S)
    valid_edges = int((batch.node_mask[batch.edge_src.long()] > 0).sum())
    valid_graphs = int(batch.graph_mask.sum())
    edges_per_s = valid_edges * n_iters / dt
    graphs_per_s = valid_graphs * n_iters / dt
    device_name = _device_name(device)

    base = edges_per_s
    if on_gpu:
        if os.path.exists(BASELINE_PATH):
            with open(BASELINE_PATH) as f:
                base = json.load(f)["edges_per_s"]
        elif not args.eager:
            with open(BASELINE_PATH, "w") as f:
                json.dump({"edges_per_s": edges_per_s,
                           "graphs_per_s": graphs_per_s,
                           "device": device_name,
                           "dtype": args.dtype}, f, indent=2)

    # roofline anchor: modeled least traffic against the memory rate
    model_bytes = _roofline_bytes(
        batch.n_cap, batch.e_cap, valid_edges, tgt_cfg.n_edge_types, HIDDEN,
        LAYERS, torch.empty((), dtype=dtype).element_size())
    hbm_bw = args.hbm_gbps * 1e9
    sol = model_bytes / (dt / n_iters) / hbm_bw
    if sol > 1.05:
        raise AssertionError(
            f"sol_fraction {sol:.3f} > 1.05: the bytes model counts more "
            f"than the forward can have moved")

    # ---- one full TRAIN step (forward + backward + Adam) on the labelled
    # batch. Training is always f32: --dtype benches the serving tower only.
    opt = train_loop.make_adam(train_params, 0.0)
    loss_fn = train_loop.neighborhood_loss_fn(train_cfg, qry_cfg, qb)
    gen = torch.Generator(device=device).manual_seed(1)
    loss = torch.zeros((), device=device)

    def step_on(b):
        loss.copy_(train_loop.train_step(train_params, opt, loss_fn, b,
                                         1e-4, gen)[0])

    step = timed_step(step_on, tb, opt.state_tensors() + [loss], gen,
                      graphed=not args.eager, capture=on_gpu)
    step()
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("the train step's loss is not finite")
    sync()
    n_train_iters = max(MIN_TRAIN_ITERS, n_iters // 4)
    t0 = time.perf_counter()
    for _ in range(n_train_iters):
        step()
    sync()
    train_dt = time.perf_counter() - t0

    print(json.dumps({
        "metric": METRIC,
        "value": round(edges_per_s, 1),
        "unit": "edges/s",
        "vs_baseline": round(edges_per_s / base, 4),
        "graphs_per_s": round(graphs_per_s, 1),
        "bytes_per_edge_layer": round(model_bytes / LAYERS / valid_edges, 1),
        "sol_fraction": round(sol, 4),
        "hbm_gbps_assumed": hbm_bw / 1e9,
        "train_edges_per_s": round(valid_edges * n_train_iters / train_dt,
                                   1),
        "train_step_ms": round(train_dt / n_train_iters * 1e3, 3),
        "dtype": args.dtype,
        "device": device_name,
        "launches": launches,
        "forward_ms": round(dt / n_iters * 1e3, 4),
        "n_cap": batch.n_cap, "e_cap": batch.e_cap,
        "valid_edges": valid_edges, "valid_graphs": valid_graphs,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
