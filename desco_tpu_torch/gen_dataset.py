"""Offline dataset materialization — the port's counterpart of desco_tpu's
root ``gen_dataset.py``: load or generate a dataset, compute and cache
its exact canonical-count ground truth, and build the neighborhood
sample cache, under ``<data_root>/<dataset>``.

    python -m desco_tpu_torch.gen_dataset --dataset Syn_1827_test --depth 4

With ``--shard k --num_shards n`` it computes only the truth of the
graphs with ``gi % n == k`` and exits (one shard per host);
``--merge_shards`` assembles the shard files into the truth cache, then
builds the samples. All of it is host work (C++ VF2 and sample prep on
``--num_cpu`` threads): nothing goes to a device. The caches have
desco_tpu's names and formats, so either package reads the other's.
"""

from __future__ import annotations

import argparse
import os
import time

from .data.datasets import load_data
from .data.workload import Workload
from .graph.atlas import gen_query_ids
from .pipeline import PipelineConfig, prepare_stage_data


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", type=str, default="Syn_1827")
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--query_sizes", type=int, nargs="+", default=[3, 4, 5])
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--num_cpu", type=int, default=None)
    p.add_argument("--shard", type=int, default=None,
                   help="compute ONLY this truth shard (graphs with "
                        "gi %% num_shards == shard) and exit — run one "
                        "shard per host, then --merge_shards")
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--merge_shards", action="store_true",
                   help="assemble all --num_shards shard files into the "
                        "canonical truth cache, then build samples")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = PipelineConfig(query_sizes=tuple(args.query_sizes),
                         depth=args.depth, data_root=args.data_root,
                         num_workers=args.num_cpu)
    t0 = time.time()
    graphs = load_data(args.dataset, args.data_root)
    print(f"loaded {len(graphs)} graphs in {time.time() - t0:.1f}s")

    wl = Workload(graphs, root=os.path.join(cfg.data_root, args.dataset),
                  name=args.dataset)
    qids = gen_query_ids(list(args.query_sizes))
    t0 = time.time()
    if args.shard is not None:
        path = wl.compute_groundtruth_shard(
            qids, args.shard, args.num_shards, num_workers=args.num_cpu)
        print(f"shard {args.shard}/{args.num_shards} -> {path} in "
              f"{time.time() - t0:.1f}s")
        return 0
    if args.merge_shards:
        truth = wl.merge_groundtruth_shards(qids, args.num_shards)
        print(f"merged {args.num_shards} shards -> {truth.shape} truth in "
              f"{time.time() - t0:.1f}s")
    else:
        truth = wl.compute_groundtruth(qids, num_workers=args.num_cpu)
        print(f"ground truth {truth.shape} for {wl.total_nodes} nodes in "
              f"{time.time() - t0:.1f}s")

    # the samples against the cached truth, into the sample cache
    t0 = time.time()
    stage = prepare_stage_data(cfg, graphs, name=args.dataset,
                               need_truth=True)
    print(f"{len(stage.samples)} neighborhoods staged in "
          f"{time.time() - t0:.1f}s ({len(stage.batches)} packed batches)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
