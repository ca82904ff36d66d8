"""Where the one-process halo train steps' time goes on the GPU.

    python -m desco_tpu_torch.tools.halo_step_profile [--calls 6]
        [--seed 0] [--out output/halo_step_profile.json]

Builds the halo training data of chip_smoke.py phases 13-14 on one card:
desco_tpu's large-graph recipe (a BA graph of 20,000 nodes, degree 4,
seed 3) in 4 shards for ``halo.halo_gossip_step_fn``, and that graph
with a 12,000-node one (seed 4), harmonized into 2 shards each, on the
2 x 2 grid of ``topology.make_mesh2d`` for ``dp_halo_gossip_step_fn``;
stage-1 counts uniform in [0, 8), truth those times a factor in [0.5,
1.5], r4's gossip tower (2 layers, hidden 64) from fresh weights, random
query embeddings, dropout 0.01.

Per step, from the same weights:

1. Eager: three calls, ms each (host clock, synchronized).
2. Graphed: the first call captures; then ``--calls`` replays, ms each
   (host clock, synchronized), the host's ms until the step returns
   (before the read-back of its loss) and in each graph's replay call,
   and their losses.
3. Device time, profiled: three more replays under ``torch.profiler``:
   wall ms, the device's busy ms (union of its kernel and copy
   intervals), its idle share, the number of device operations, and
   every kernel name with its calls and device ms, the device's idle
   gaps between operations by length, and how often the device's next
   operation is another kernel than the one before (switches).

Steps 2 and 3 run twice, each time on a new capture in the same process.

Prints one JSON object (and writes it to ``--out``). Needs a CUDA device.
It calls only entry points that the port has had since the halo steps
were first captured, so the same file measures an older checkout of the
package: copy it into that checkout's ``tools/`` and run it from there.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import time
from collections import defaultdict

import numpy as np

from .serving_profile import _busy_us

N_QUERIES = 29


def ba_graph(Graph, n: int, degree: int, seed: int):
    """desco_tpu's large-graph recipe: node v attaches to min(v, degree
    // 2) uniform earlier nodes (duplicates merged)."""
    rng = np.random.default_rng(seed)
    pairs = set()
    for v in range(1, n):
        m = min(v, max(1, degree // 2))
        for t in set(rng.integers(0, v, m).tolist()):
            pairs.add((t, v))
    return Graph(n, np.array(sorted(pairs), np.int32))


def gossip_spec(g, rng) -> dict:
    """``partition_typed_graph``'s arguments for a training graph."""
    from ..batch.build import gossip_sample

    x = rng.uniform(0.0, 8.0, (g.n_nodes, N_QUERIES)).astype(np.float32)
    truth = (x * rng.uniform(0.5, 1.5, (g.n_nodes, 1))).astype(np.float32)
    s = gossip_sample(g, x, truth)
    return dict(n_nodes=g.n_nodes, node_type=s.node_type, x=x,
                edge_src=s.edge_src, edge_dst=s.edge_dst,
                edge_type=s.edge_type, node_y=truth)


def device_profile(torch, fn) -> dict:
    """``fn()`` (ending in a synchronization) under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device, names, by_kernel = [], [], defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        device.append((ev.time_range.start, ev.time_range.end))
        names.append((ev.time_range.start, ev.name))
        k = by_kernel[ev.name]
        k[0] += 1
        k[1] += ev.time_range.elapsed_us()
    busy_ms = _busy_us(device) / 1e3
    kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_ops": len(device), "gaps": gap_bins(device),
            "switches": sum(a[1] != b[1] for a, b in
                            zip(sorted(names), sorted(names)[1:])),
            "kernels": [{"name": nm[:120], "calls": c, "ms": us / 1e3}
                        for nm, (c, us) in kernels]}


GAP_EDGES_US = (1.0, 2.0, 5.0, 20.0, 100.0, 1000.0)


def gap_bins(intervals) -> dict:
    """The device's idle gaps between one operation's end and the next
    one's start (over the union of the intervals), by length: per bin
    (upper edges ``GAP_EDGES_US``, then the rest) the count and the ms,
    and the five longest in ms."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append(s - end)
        end = e if end is None else max(end, e)
    bins = [[0, 0.0] for _ in range(len(GAP_EDGES_US) + 1)]
    for g in gaps:
        i = next((i for i, edge in enumerate(GAP_EDGES_US) if g < edge),
                 len(GAP_EDGES_US))
        bins[i][0] += 1
        bins[i][1] += g / 1e3
    return {"edges_us": list(GAP_EDGES_US), "count": [b[0] for b in bins],
            "ms": [b[1] for b in bins],
            "longest_ms": [g / 1e3 for g in sorted(gaps)[-5:][::-1]]}


class GraphLog:
    """Every CUDA graph the steps make, through a ``torch.cuda.CUDAGraph``
    subclass put in its place while the log is open: the host ms of each
    replay (``cudaGraphLaunch`` until it returns)."""

    def __init__(self, torch):
        self.torch, self.graphs = torch, []
        self.replays = defaultdict(list)

    def __enter__(self):
        log, base = self, self.torch.cuda.CUDAGraph
        self._base = base

        class Logged(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                log.graphs.append(self)

            def replay(self):
                t0 = time.perf_counter()
                super().replay()
                log.replays[log.graphs.index(self)].append(
                    (time.perf_counter() - t0) * 1e3)

        self.torch.cuda.CUDAGraph = Logged
        return self

    def __exit__(self, *exc):
        self.torch.cuda.CUDAGraph = self._base


def measure(torch, make_step, params, place, q_embs, calls: int) -> dict:
    """One step kind eager, then graphed twice (two captures in the same
    process), from the same weights."""
    from ..train import loop

    lr = torch.tensor(1e-3, device=q_embs.device)

    def timed(step, p, n, seed0):
        ms, host_ms, losses = [], [], []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = step(p, place, q_embs, lr, seed=seed0 + i)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms, host_ms, losses

    out = {}
    p = copy.deepcopy(params)
    e_ms, _, e_loss = timed(make_step(loop.make_adam(p), False), p, 3, 0)
    out["eager"] = {"ms": e_ms, "losses": e_loss}
    for name in ("graphed", "graphed_again"):
        p = copy.deepcopy(params)
        with GraphLog(torch) as log:
            step = make_step(loop.make_adam(p), True)
            t0 = time.perf_counter()
            first, _ = step(p, place, q_embs, lr, seed=0)
            float(first)
            capture_s = time.perf_counter() - t0
            log.replays.clear()
            g_ms, host_ms, g_loss = timed(step, p, calls, 1)
        replay_ms = [log.replays[i] for i in range(len(log.graphs))]

        def three():
            for i in range(3):
                step(p, place, q_embs, lr, seed=i)
            torch.cuda.synchronize()

        out[name] = {"capture_s": capture_s, "ms": g_ms, "host_ms": host_ms,
                     "replay_host_ms": replay_ms, "losses": g_loss,
                     "profile_3_calls": device_profile(torch, three)}
        del step
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="output/halo_step_profile.json")
    args = ap.parse_args(argv)

    import torch

    from ..graph.container import Graph
    from ..models import gossip as gossip_mod
    from ..parallel import halo, topology

    if not torch.cuda.is_available():
        raise SystemExit("halo_step_profile needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(args.seed + 14)
    g1 = ba_graph(Graph, 20000, 4, 3)
    g2 = ba_graph(Graph, 12000, 4, 4)
    spec1, spec2 = gossip_spec(g1, rng), gossip_spec(g2, rng)
    part = halo.partition_typed_graph(n_devices=4, n_types=2, **spec1)
    shards = halo.place_shards(part, [dev])
    parts = topology.harmonized_partitions([spec1, spec2], 2, n_types=2)
    grid = topology.place_replicas(topology.stack_partitions(parts),
                                   topology.make_mesh2d(2, 2, devices=[dev]))
    params = gossip_mod.init_gossip_model(
        hidden_dim=64, emb_channels=64,
        generator=torch.Generator().manual_seed(args.seed)).to(dev)
    q_embs = torch.randn(N_QUERIES, 64, generator=torch.Generator()
                         .manual_seed(args.seed + 1)).to(dev)
    res = {
        "card": card, "calls": args.calls,
        "halo_step": measure(
            torch, lambda opt, g: halo.halo_gossip_step_fn(
                opt, 0.01, graphed=g), params, shards, q_embs, args.calls),
        "dp_halo_step": measure(
            torch, lambda opt, g: topology.dp_halo_gossip_step_fn(
                opt, 0.01, graphed=g), params, grid, q_embs, args.calls),
    }
    text = json.dumps(res, indent=1)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    for kind, name in [(k, n) for k in ("halo_step", "dp_halo_step")
                       for n in ("graphed", "graphed_again")]:
        g = res[kind][name]
        prof = g["profile_3_calls"]
        print(f"{kind} ({name}): ms {[round(x, 2) for x in g['ms']]} (host "
              f"{[round(x, 2) for x in g['host_ms']]}; per graph's replay "
              f"{[[round(x, 2) for x in r] for r in g['replay_host_ms']]}), "
              f"eager "
              f"{[round(x, 1) for x in res[kind]['eager']['ms']]}; profiled "
              f"3 calls: busy {prof['device_busy_ms']:.2f} ms of "
              f"{prof['wall_ms']:.2f}, {prof['device_ops']} device ops, "
              f"{prof['switches']} switches, gaps "
              f"{json.dumps(prof['gaps'])} ({card})", flush=True)
    print(json.dumps({k: v for k, v in res.items() if k == "card"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
