"""Decomposition complexity study.

    python -m desco_tpu_torch.tools.complexity_analysis --dataset Syn_64

The port of desco_tpu's ``experimental/complexity_analysis.py``, with its
flags and printed lines: Σ f(n) over whole graphs (graphlet counting)
against Σ f(n) over canonical neighborhoods, for f in {n², 2ⁿ, n·n!},
which is why canonical partition makes counting tractable (a
neighborhood is bounded by its depth-d ball whatever the graph's size).
The sums are exact Python integers on the host. ``--device`` is resolved
as every tool resolves it (the card unless ``--device cpu``), so a run
fails the same way as the others where no card is visible.
"""

from __future__ import annotations

import argparse
import math
from decimal import Decimal


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.tools.complexity_analysis")
    p.add_argument("--dataset", type=str, default="Syn_64")
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p


FUNCS = {
    "n^2": lambda x: x ** 2,
    "2^n": lambda x: 2 ** x,
    "n*n!": lambda x: x * math.factorial(x),
}


def run(args, log=print) -> dict:
    """Returns {f: (graphlet sum, neighborhood sum)} and the counts."""
    from ..data.datasets import load_data
    from ..data.workload import Workload
    from ..utils.device import resolve_device

    resolve_device(args.device)
    graphs = load_data(args.dataset, args.data_root)
    wl = Workload(graphs, root=f"{args.data_root}/{args.dataset}",
                  name=args.dataset)
    neighs, _ = wl.extract_neighborhoods(args.depth)
    whole = [g.n_nodes for g in graphs]
    parts = [nb.graph.n_nodes for nb in neighs]
    log(f"dataset: {args.dataset}  graphs={len(whole)} "
        f"neighborhoods={len(parts)}")
    sums = {}
    for name, f in FUNCS.items():
        cw = sum(f(n) for n in whole)
        cp = sum(f(n) for n in parts)
        sums[name] = (cw, cp)
        log(f"  f={name:5s}  graphlet: {Decimal(cw):.2e}   "
            f"neighborhood: {Decimal(cp):.2e}   "
            f"ratio: {Decimal(cw) / Decimal(max(cp, 1)):.2e}")
    return {"graphs": len(whole), "neighborhoods": len(parts),
            "sums": sums}


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
