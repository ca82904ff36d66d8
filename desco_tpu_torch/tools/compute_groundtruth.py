"""Offline exact ground truth for arbitrary query sets (size 6 and up).

    python -m desco_tpu_torch.tools.compute_groundtruth --dataset ENZYMES \\
        --query_sizes 6 --output out/ground_truth_size6.csv
    python -m desco_tpu_torch.tools.compute_groundtruth --dataset MUTAG \\
        --queries_pickle mined_patterns.p

The port of desco_tpu's ``analysis/compute_groundtruth.py``, with its
flags, printed lines and CSV: the canonical-count ground truth of a
dataset against a query set that is not the standard 3/4/5 atlas sweep,
given by size (``--query_sizes 6``), by explicit atlas ids
(``--query_ids``, the extended ids 8000-14004 included) or as a pickle of
mined networkx patterns (``--queries_pickle``), then the graph-level
count sums beside each query's size. Counting runs through the
thread-pooled native VF2 (truth/native.py) with the disk cache keyed by
the query signature. The work is the host's; ``--device`` is resolved
as every tool resolves it (the card unless ``--device cpu``), so a run
fails the same way as the others where no card is visible.

A pickle of networkx graphs cannot be read without networkx, so that
branch imports it and says so when it is missing.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.tools.compute_groundtruth")
    p.add_argument("--dataset", type=str, default="ENZYMES")
    p.add_argument("--query_sizes", type=int, nargs="+", default=[6])
    p.add_argument("--query_ids", type=int, nargs="+", default=None,
                   help="explicit atlas ids (overrides --query_sizes)")
    p.add_argument("--queries_pickle", type=str, default=None,
                   help="pickle of a list of networkx query graphs "
                        "(overrides ids/sizes)")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p


def _pickled_queries(path: str):
    """The queries of a pickle of networkx graphs (the mining output)."""
    try:
        import networkx  # noqa: F401 (unpickling needs its classes)
    except ImportError as e:
        raise RuntimeError(
            f"--queries_pickle {path}: a pickle of networkx graphs needs "
            f"networkx to be read, and it is not installed") from e
    from ..graph.container import Graph

    with open(path, "rb") as f:
        nx_queries = pickle.load(f)
    out = []
    for q in nx_queries:
        n = q.number_of_nodes()
        if set(q.nodes) != set(range(n)):
            raise ValueError("query nodes must be 0..n-1")
        out.append(Graph(n, np.array(
            [(min(u, v), max(u, v)) for u, v in q.edges() if u != v],
            np.int32).reshape(-1, 2)))
    return out


def run(args, log=print) -> dict:
    """Returns the per-node truth, the totals, the sizes and the query
    ids (the pickle's are 0..n-1, its cache signature)."""
    from ..data.datasets import load_data
    from ..data.workload import Workload
    from ..graph.atlas import gen_queries, gen_query_ids
    from ..utils.device import resolve_device

    resolve_device(args.device)
    if args.queries_pickle:
        queries = _pickled_queries(args.queries_pickle)
        query_ids = list(range(len(queries)))  # signature only
        log(f"loaded {len(queries)} mined queries from "
            f"{args.queries_pickle}")
    else:
        query_ids = args.query_ids or gen_query_ids(args.query_sizes)
        queries = gen_queries(query_ids)
        log(f"use queries with atlas ids: {query_ids}")

    graphs = load_data(args.dataset, args.data_root)
    wl = Workload(graphs, os.path.join(args.data_root, args.dataset),
                  name=args.dataset)
    truth = wl.compute_groundtruth(query_ids, queries=queries)

    # graph-level counts = per-graph column sums of canonical counts
    graphlet = np.stack([
        truth[wl.node_offsets[i]:wl.node_offsets[i + 1]].sum(0)
        for i in range(len(graphs))
    ])
    total = graphlet.sum(0).astype(np.int64)
    sizes = np.array([q.n_nodes for q in queries], np.int64)
    out = np.stack([total, sizes], axis=1)
    log("ground truth sum (count, query_size):")
    log(out)
    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with open(args.output, "w") as f:
            f.write(",count,query_size\n")
            for i, (c, s) in enumerate(out):
                f.write(f"{i},{c},{s}\n")
        log(f"saved to {args.output}")
    return {"query_ids": list(query_ids), "queries": queries,
            "truth": truth, "graphlet": graphlet, "total": total,
            "sizes": sizes, "graphs": graphs}


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
