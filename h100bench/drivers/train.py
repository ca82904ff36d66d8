"""Neighborhood-stage training through the loop's compiled steps.

Set-up draws the mix's graphs from the Syn_1827 grid (from the mix's
``graph_seed``: the same dataset for every run, as a trainer's is), one
label per node and query from ``--seed`` (log2(count + 1) uniform in
[0, ``label_log2_max``]; the step's work does not depend on the
values: ``smooth_l1`` takes both branches of its ``where`` for every
element), decomposes and packs them through the program's host layer as
its training set-up does, makes the weights on the device from
``--seed``, and builds one
``train/loop.Steps`` over the resident batches, as ``run_training``
does. Its first ``check_steps`` steps, on the first batches of epoch
0's shuffle, run through the window's own call before the window and
are read back: each step's loss, the first gradient (Adam's first moment
after one step, over 1 - b1) and the weights' change after the last.
The window continues epoch after epoch, each shuffled as the loop
shuffles it, and counts the canonical neighborhoods stepped through.

Correctness: the plain reference works the neighborhoods, batches,
losses, gradients and Adam updates of those steps out again from the
same graphs, labels and weights.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict

import numpy as np

from ..gen import syn1827
from ..lib import flops as fl
from ..lib import weights as wt
from ..lib.context import Context
from ..lib.trace import Recorder, breakdown, device_profile
from ..reference import pipeline as ref

B1 = 0.9  # Adam's first-moment decay, the program's and the reference's


def leaf_gaps(prog: Dict[str, np.ndarray], refs: Dict[str, np.ndarray],
              grads: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Per leaf, the gap between the program's and the reference's norm,
    over the larger of the reference's norm of that leaf and of the
    median leaf. Leaves whose reference gradient is under a thousandth of
    the median leaf's are left out: they move by round-off alone."""
    gnorm = {k: float(np.linalg.norm(v)) for k, v in grads.items()}
    g_med = float(np.median(list(gnorm.values())))
    keep = [k for k in refs if gnorm[k] >= 1e-3 * g_med]
    rnorm = {k: float(np.linalg.norm(refs[k])) for k in keep}
    med = float(np.median(list(rnorm.values())))
    return {k: abs(float(np.linalg.norm(prog[k])) - rnorm[k])
            / max(rnorm[k], med) for k in keep}


def compare(prog: dict, r: dict, worst: dict = None) -> Dict[str, float]:
    """``loss_gap``: the widest relative gap of a step's loss;
    ``loss1_gap``: of the first step's loss; ``grad_gap``: of the first
    gradient's norm, by the worst leaf, ``grad_med_gap`` at the median
    leaf; ``delta_gap``: of the norm of the weights' change over the
    steps, by the worst leaf, ``delta_med_gap`` at the median leaf.
    ``worst``, a dict, gets the worst leaves' names."""
    grads = {k: v.detach().cpu().numpy().astype(np.float64)
             for k, v in r["grad"].items()}
    delta = {k: v.detach().cpu().numpy().astype(np.float64)
             for k, v in r["delta"].items()}
    lp, lr = np.asarray(prog["losses"]), np.asarray(r["losses"])
    if lp.shape != lr.shape:
        return {k: float("inf") for k in ("loss_gap", "loss1_gap",
                                          "grad_gap", "grad_med_gap",
                                          "delta_gap", "delta_med_gap")}
    losses = np.abs(lp - lr) / np.abs(lr)
    d = leaf_gaps(prog["delta"], delta, grads)
    g = leaf_gaps(prog["grad"], grads, grads)
    if worst is not None:
        worst.update(grad=max(g, key=g.get), delta=max(d, key=d.get))
    return {"loss_gap": float(losses.max()), "loss1_gap": float(losses[0]),
            "grad_gap": float(max(g.values())),
            "grad_med_gap": float(np.median(list(g.values()))),
            "delta_gap": float(max(d.values())),
            "delta_med_gap": float(np.median(list(d.values())))}


def run(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, build_dir: str) -> dict:
    """One run of the cell. Besides the result, ``reference`` holds what
    the check compared: the reference's inputs and run, and the
    program's readings."""
    import torch

    from desco_tpu_torch.batch.packed import (auto_capacities, pack_samples,
                                              stack_batches)
    from desco_tpu_torch.data.workload import Workload
    from desco_tpu_torch.graph import Graph
    from desco_tpu_torch.models import neighborhood as neigh_mod
    from desco_tpu_torch.models.shmp_gnn import prepare_batch
    from desco_tpu_torch.pipeline import (PipelineConfig, build_query_batch,
                                          model_configs)
    from desco_tpu_torch.train import loop
    from desco_tpu_torch.train.checkpoint import jax_keys
    from desco_tpu_torch.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache(build_dir)
    s64 = int(seed) & (2**63 - 1)
    t0 = time.perf_counter()
    lo_n, hi_n = traffic["grid_nodes"]
    sids = syn1827.grid_ids(lo_n, hi_n, traffic["grid_modulus"],
                            traffic["grid_residue"])[:traffic.get("pool_limit")]
    graphs = syn1827.make_graphs(sids, traffic["graph_seed"])
    n_q = len(cfg_queries(cfg))
    n_total = sum(n for n, _ in graphs)
    labels = np.exp2(np.random.default_rng([s64, 7]).uniform(
        0.0, traffic["label_log2_max"], (n_total, n_q))) - 1.0
    t_graphs = time.perf_counter() - t0

    t1 = time.perf_counter()
    pcfg = PipelineConfig(**wt.pipeline_config(cfg))
    wl = Workload([Graph(n, e) for n, e in graphs], name="train")
    samples, _ = wl.neighborhood_samples(pcfg.depth, use_tconv=pcfg.use_tconv,
                                         truth=labels, order=pcfg.order)
    caps = auto_capacities(samples, g_cap=pcfg.neigh_batch_size)
    batches = pack_samples(samples, *caps, n_queries=n_q, need_bwd_perm=True)
    t_prep = time.perf_counter() - t1

    t2 = time.perf_counter()
    tgt_cfg, qry_cfg = model_configs(pcfg, device)
    w0 = wt.make_weights(wt.neighborhood_specs(cfg), seed, 0, device)
    params = neigh_mod.init_neighborhood_model(tgt_cfg, qry_cfg)
    keys = jax_keys(params)
    params.load_state_dict({sk: w0[jk].cpu() for sk, jk in keys.items()})
    params = params.to(device)
    qb = build_query_batch(pcfg).to(device)
    prepare_batch(qb, qry_cfg.n_edge_types, backward=True)
    opt = loop.make_adam(params, pcfg.neigh_weight_decay)
    stacked = stack_batches(batches).to(device, training=True)
    train_dev = [stacked[i] for i in range(len(batches))]
    lr_dev = torch.tensor(float(pcfg.neigh_lr), dtype=torch.float32,
                          device=device)
    steps = loop.Steps(
        params, opt, loop.neighborhood_loss_fn(tgt_cfg, qry_cfg, qb),
        loop.neighborhood_eval_fn(tgt_cfg, qry_cfg, qb), train_dev, None,
        lr_dev, torch.Generator(device=device), device, graphed=True,
        prepare=lambda b, backward: prepare_batch(b, tgt_cfg.n_edge_types,
                                                  backward))
    live = [int(np.asarray(b.graph_mask).sum()) for b in batches]
    shapes = [fl.batch_shape(b.node_mask, b.graph_mask, b.edge_dst,
                             b.edge_type, tgt_cfg.n_edge_types)
              for b in batches]

    # epoch 0 as the loop starts it; its first steps are read back
    rng_np = np.random.default_rng(s64 + 1)
    epoch = 0
    steps.reseed(loop._epoch_seed(s64, epoch))
    order = rng_np.permutation(len(train_dev))
    loss_sum, n_bad = steps.train_carry
    n_bad.zero_()
    losses, grad = [], None
    n_check = traffic["check_steps"]
    for i in range(n_check):
        loss_sum.zero_()
        steps.train(train_dev[int(order[i])])
        losses.append(float(loss_sum))
        if i == 0:
            mu = opt.state_arrays()
            grad = {k: mu["mu/" + k].astype(np.float64) / (1.0 - B1)
                    for k in keys.values()}
    state = {sk: v.detach().cpu().numpy().astype(np.float64)
             for sk, v in params.state_dict().items()}
    delta = {keys[sk]: v - w0[keys[sk]].cpu().numpy().astype(np.float64)
             for sk, v in state.items()}
    prog = {"losses": losses, "grad": grad, "delta": delta}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_steps = time.perf_counter() - t2
    setup_s = time.perf_counter() - t_start

    rec = Recorder()
    span = rec.span if trace else (lambda name: contextlib.nullcontext())
    window = min(seconds, traffic.get("trace_seconds", seconds)) \
        if trace else seconds
    sync_every = traffic["sync_every"]
    pos, n_steps, n_neigh, bad, host_s, stepped = n_check, 0, 0, 0, 0.0, []
    with device_profile(trace, device.type) as prof:
        # the window opens once the profiler runs
        start = time.perf_counter()
        end = start + window
        start_ns = time.time_ns()
        last = start
        while True:
            if pos == len(order):
                with span("epoch_end"):
                    bad += int(n_bad)  # the loop's one read-back an epoch
                    epoch += 1
                    steps.reseed(loop._epoch_seed(s64, epoch))
                    order = rng_np.permutation(len(train_dev))
                    loss_sum.zero_()
                    n_bad.zero_()
                    pos = 0
            bi = int(order[pos])
            h0 = time.perf_counter()
            with span("step"):
                steps.train(train_dev[bi])
            host_s += time.perf_counter() - h0
            pos += 1
            n_steps += 1
            n_neigh += live[bi]
            stepped.append(bi)
            if n_steps % sync_every == 0:
                with span("sync"):
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                last = time.perf_counter()
                if last >= end:
                    break
        bad += int(n_bad)
        hi_ns = time.time_ns()
    elapsed = last - start

    metrics = {"setup_s": setup_s,
               "train_neigh_per_s": n_neigh / elapsed}
    diag = {"steps": n_steps, "epochs_started": epoch + 1,
            "batches": len(batches), "caps": list(caps),
            "setup_parts_s": {"graphs": t_graphs, "prep": t_prep,
                              "steps_and_capture": t_steps}}
    ctx = None
    if trace and prof:
        ctx = Context(cfg, traffic, prof[0], rec.spans, start_ns, hi_ns,
                      {"steps": float(n_steps),
                       "neighborhoods": float(n_neigh),
                       "flops": sum(fl.train_step_flops(shapes[bi], cfg, n_q)
                                    for bi in stepped),
                       "host_step_s": host_s},
                      fl.peaks(),
                      {"target": [shapes[bi] for bi in stepped]})
        ctx.counters["breakdown"] = breakdown(prof[0], rec.spans, start_ns,
                                              hi_ns)

    n_batches = len(batches)
    del steps, opt, params, stacked, train_dev, qb
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    first = [int(b) for b in order_first(s64, n_batches, n_check)]
    args = (graphs, labels, w0, cfg["conv_type"], cfg["depth"], caps, first,
            float(cfg["neigh_lr"]), device)
    r = ref.train(*args)
    worst: dict = {}
    numbers = compare(prog, r, worst)
    diag["worst_leaves"] = worst
    if r["n_batches"] != n_batches:
        numbers = {k: float("inf") for k in numbers}
    diag["reference_batches"] = r["n_batches"]
    return {"metrics": metrics, "numbers": numbers,
            "attempted": n_steps + n_check, "failed": bad,
            "context": ctx, "memory_peak_bytes": peak, "diagnostics": diag,
            "reference": {"args": args, "r": r, "prog": prog}}


def order_first(s64: int, n_batches: int, k: int):
    """The first ``k`` batches of epoch 0's shuffle, as the loop draws it
    (``np.random.default_rng(seed + 1).permutation``)."""
    return np.random.default_rng(s64 + 1).permutation(n_batches)[:k]


def cfg_queries(cfg: dict):
    from ..reference.queries import QUERIES

    sizes = set(cfg["query_sizes"])
    return [q for q in QUERIES if q[1] in sizes]
