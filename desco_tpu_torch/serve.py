"""Serving daemon: graphs in, graphlet counts out (``python -m
desco_tpu_torch.serve``) — the port of the repo's ``serve.py``.

Protocol: line-delimited JSON. One request per line:

    {"id": 7, "graphs": [{"n": 5, "edges": [[0,1],[1,2],[3,4]]}, ...],
     "refine": true, "node_counts": false}

One response line per request, in order:

    {"id": 7, "graphlet_counts": [[...29 floats...], ...],
     "refined": true, "verified": 3}

Errors come back as {"id": ..., "error": "..."} without killing the
daemon; a line ``quit`` ends it. The service runs on CUDA unless
``--device cpu`` is given.

Usage:
  python -m desco_tpu_torch.serve --neigh_ckpt release/r4/neigh.best \\
      --gossip_ckpt release/r4/gossip.best         # stdin/stdout
"""

from __future__ import annotations

import argparse
import json
import sys


def build_service(args):
    from .serving import CountingService

    overrides = {}
    if args.verify_budget is not None:
        overrides["verify_budget"] = args.verify_budget
    if args.exact_size:
        overrides["exact_size"] = args.exact_size
    return CountingService(
        args.neigh_ckpt, args.gossip_ckpt,
        config_overrides=overrides or None, device=args.device)


def handle(svc, req: dict) -> dict:
    import numpy as np

    from .graph import Graph

    graphs = [
        Graph(int(g["n"]), np.asarray(g.get("edges", []), np.int32))
        for g in req["graphs"]
    ]
    res = svc.count(graphs, refine=req.get("refine"))
    out = {
        "id": req.get("id"),
        "graphlet_counts": res.graphlet_counts.tolist(),
        "refined": res.refined,
        "verified": int(len(res.verified_rows)),
    }
    if req.get("node_counts"):
        out["node_counts"] = res.node_counts.tolist()
    return out


def serve_lines(svc, rfile, wfile) -> None:
    for line in rfile:
        line = line.strip()
        if not line:
            continue
        if line in ("quit", "exit"):
            break
        rid = None
        try:
            req = json.loads(line)
            rid = req.get("id")
            out = handle(svc, req)
        except Exception as e:  # the daemon survives bad requests
            out = {"id": rid, "error": f"{type(e).__name__}: {e}"}
        wfile.write(json.dumps(out) + "\n")
        wfile.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m desco_tpu_torch.serve")
    ap.add_argument("--neigh_ckpt", required=True)
    ap.add_argument("--gossip_ckpt", default=None)
    ap.add_argument("--verify_budget", type=float, default=None)
    ap.add_argument("--exact_size", type=int, default=0,
                    help="serve queries with <= N nodes exactly")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without "
                         "a GPU unless 'cpu' is given)")
    args = ap.parse_args(argv)

    svc = build_service(args)
    print("ready", file=sys.stderr, flush=True)

    serve_lines(svc, sys.stdin, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
