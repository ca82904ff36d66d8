"""Where one training epoch's time goes on the GPU, for both stages.

    python -m desco_tpu_torch.tools.training_profile [--graphs 128]
        [--seed 0] [--out output/training_profile.json]

Trains the paper config (SAGE SHMP, 8 layers, hidden 64, 29 queries,
neighborhood batch 512; gossip 2 layers, batch 256, dropout 0.01) from
fresh weights on ``SynNp_<graphs>`` (data/datasets.py) with exact ground
truth; the gossip stage's input counts are the truth times a random
factor in [0.5, 1.5], so the tool needs no trained neighborhood model.
Per stage, after one warm-up epoch:

1. Stage times, synchronized: one epoch whose steps are cut into forward
   (loss), backward and optimizer by a host clock that synchronizes the
   device at every cut, then the val pass (forward only over the same
   batches, as train = valid runs it).
2. Epoch wall time, unsynchronized: one epoch through the loop's own
   ``train_step`` with one synchronization at its end, and the val pass
   the same way. What the synchronized stages add up to beyond it is the
   cost of the cuts; what the wall time has beyond the device's busy time
   is the host (Python and kernel launches).
3. Device time, profiled: the same epoch (train steps, then val) under
   ``torch.profiler``: the device's busy time (union of its kernel and
   copy intervals), its idle share over the profiled wall time, the
   number of device operations and the kernels with the most device time.

Prints one JSON object (and writes it to ``--out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import numpy as np

from .serving_profile import _busy_us


def _profile_stage(torch, params, opt, loss_fn, eval_fn, batches, lr,
                   generator) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..train.loop import train_step

    sync = torch.cuda.synchronize

    def train_epoch():
        for b in batches:
            train_step(params, opt, loss_fn, b, lr, generator)

    def val_pass():
        with torch.no_grad():
            for b in batches:
                eval_fn(params, b)

    train_epoch()  # warm-up: index streams, allocator, kernel load
    val_pass()
    sync()

    cut = defaultdict(float)
    for b in batches:
        sync()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = loss_fn(params, b, generator)
        sync()
        t1 = time.perf_counter()
        loss.backward()
        sync()
        t2 = time.perf_counter()
        opt.step(lr, torch.isfinite(loss.detach()))
        sync()
        t3 = time.perf_counter()
        cut["forward"] += t1 - t0
        cut["backward"] += t2 - t1
        cut["optimizer"] += t3 - t2
    t0 = time.perf_counter()
    val_pass()
    sync()
    cut["val"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    train_epoch()
    sync()
    train_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    val_pass()
    sync()
    val_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_epoch()
        val_pass()
        sync()
        prof_ms = (time.perf_counter() - t0) * 1e3
    device, by_kernel = [], defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        device.append((ev.time_range.start, ev.time_range.end))
        k = by_kernel[ev.name]
        k[0] += 1
        k[1] += ev.time_range.elapsed_us()
    busy_ms = _busy_us(device) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:10]
    n = len(batches)
    return {
        "steps_per_epoch": n,
        "synchronized_ms": {k: v * 1e3 for k, v in cut.items()},
        "train_epoch_ms": train_ms,
        "train_step_ms": train_ms / n,
        "val_pass_ms": val_ms,
        "epoch_ms": train_ms + val_ms,
        "profiled_epoch_ms": prof_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / prof_ms,
        "device_ops": len(device),
        "top_kernels": [{"name": nm[:100], "calls": c, "ms": us / 1e3}
                        for nm, (c, us) in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.tools.training_profile")
    ap.add_argument("--graphs", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from ..batch.packed import PAD_EDGE_TYPE, stack_batches
    from ..data.datasets import load_data
    from ..models import gossip as gossip_mod
    from ..models import neighborhood as neigh_mod
    from ..pipeline import (PipelineConfig, build_query_batch, model_configs,
                            prepare_gossip_batches, prepare_stage_data)
    from ..train import loop
    from ..utils.device import resolve_device

    if not torch.cuda.is_available():
        raise SystemExit("training_profile needs a CUDA device")
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    name = f"SynNp_{args.graphs}_{args.seed}"
    with tempfile.TemporaryDirectory(prefix="desco_profile_") as root:
        cfg = PipelineConfig(seed=args.seed, data_root=root)
        graphs = load_data(name)
        t0 = time.perf_counter()
        stage = prepare_stage_data(cfg, graphs, name=name, need_truth=True)
        prep_s = time.perf_counter() - t0
    tgt_cfg, qry_cfg = model_configs(cfg, dev)
    qb = build_query_batch(cfg).to(dev)
    gen_init = torch.Generator().manual_seed(args.seed)
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    def resident(batches):
        stacked = stack_batches(batches).to(dev, training=True)
        return [stacked[i] for i in range(len(batches))]

    def live(batches):
        return int(sum((b.edge_type != PAD_EDGE_TYPE).sum()
                       for b in batches))

    out = {"card": card, "device": torch.cuda.get_device_name(0),
           "dataset": name, "nodes": int(stage.workload.total_nodes),
           "truth_and_staging_s": prep_s}

    params = neigh_mod.init_neighborhood_model(tgt_cfg, qry_cfg,
                                               gen_init).to(dev)
    b0 = stage.batches[0]
    out["neighborhood"] = dict(
        n_cap=b0.n_cap, e_cap=b0.e_cap, g_cap=b0.g_cap,
        live_edges_per_epoch=live(stage.batches),
        **_profile_stage(
            torch, params, loop.make_adam(params),
            loop.neighborhood_loss_fn(tgt_cfg, qry_cfg, qb),
            loop.neighborhood_eval_fn(tgt_cfg, qry_cfg, qb),
            resident(stage.batches), cfg.neigh_lr, generator))

    with torch.no_grad():
        q_embs = neigh_mod.embed_queries(params, qry_cfg, qb)
    counts = (stage.truth[stage.nindex.indicator]
              * np.random.default_rng(args.seed).uniform(
                  0.5, 1.5, (len(stage.samples), 1)))
    gbatches = prepare_gossip_batches(cfg, stage, counts, need_bwd_perm=True)
    gparams = gossip_mod.init_gossip_model(
        hidden_dim=cfg.gossip_hidden_dim, emb_channels=cfg.neigh_hidden_dim,
        layer_num=cfg.gossip_layer_num, generator=gen_init).to(dev)
    g0 = gbatches[0]
    out["gossip"] = dict(
        n_cap=g0.n_cap, e_cap=g0.e_cap, g_cap=g0.g_cap,
        live_edges_per_epoch=live(gbatches),
        **_profile_stage(
            torch, gparams, loop.make_adam(gparams),
            loop.gossip_loss_fn(cfg.gossip_dropout, q_embs),
            loop.gossip_eval_fn(q_embs), resident(gbatches), cfg.gossip_lr,
            generator))

    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
