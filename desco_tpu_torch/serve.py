"""Serving daemon: graphs in, graphlet counts out (``python -m
desco_tpu_torch.serve``) — the port of the repo's ``serve.py``.

Protocol: line-delimited JSON. One request per line:

    {"id": 7, "graphs": [{"n": 5, "edges": [[0,1],[1,2],[3,4]]}, ...],
     "refine": true, "node_counts": false}

One response line per request, in order:

    {"id": 7, "graphlet_counts": [[...29 floats...], ...],
     "refined": true, "verified": 3}

A request with one graph of at least ``--large_threshold`` nodes
(default 5000) goes to ``CountingService.count_large_graph``, whose
gossip stage runs halo-sharded (over stdio and ``--tcp`` alike). Errors
come back as {"id": ..., "error": "..."} without killing the daemon; a
line ``quit`` ends it (on TCP: ends that connection). The service runs
on CUDA unless ``--device cpu`` is given; ``--bf16`` runs the target
tower in bfloat16; several ``--neigh_ckpt`` paths serve their ensemble;
``--n_devices`` above 1 serves over that many data-parallel replicas (-1:
one per visible GPU), and ``--compile_cache DIR`` builds the kernels into
DIR once for every later start. The service replays its compiled
forwards (CUDA graphs).

The daemon is one process, as desco_tpu's is: it reads one stdin per
process, and desco_tpu serves per process (it cannot read a sharded
result back across processes; ``serving.py``'s docstring), so no user
runs it across the ranks of a process group.

Usage:
  python -m desco_tpu_torch.serve --neigh_ckpt release/r4/neigh.best \\
      --gossip_ckpt release/r4/gossip.best         # stdin/stdout
  python -m desco_tpu_torch.serve ... --tcp 127.0.0.1:8345   # line-JSON TCP
"""

from __future__ import annotations

import argparse
import json
import sys

LARGE_THRESHOLD = 5000  # nodes of a single graph served halo-sharded


def build_service(args):
    from .serving import CountingService

    overrides = {}
    if args.verify_budget is not None:
        overrides["verify_budget"] = args.verify_budget
    if args.exact_size:
        overrides["exact_size"] = args.exact_size
    if args.bf16:
        overrides["serve_bf16"] = True
    return CountingService(
        args.neigh_ckpt, args.gossip_ckpt,
        config_overrides=overrides or None, n_devices=args.n_devices,
        compile_cache=args.compile_cache, device=args.device)


def handle(svc, req: dict, large_threshold: int = LARGE_THRESHOLD) -> dict:
    import numpy as np

    from .graph import Graph

    graphs = [
        Graph(int(g["n"]), np.asarray(g.get("edges", []), np.int32))
        for g in req["graphs"]
    ]
    refine = req.get("refine")
    if len(graphs) == 1 and graphs[0].n_nodes >= large_threshold:
        res = svc.count_large_graph(graphs[0], refine=refine)
    else:
        res = svc.count(graphs, refine=refine)
    out = {
        "id": req.get("id"),
        "graphlet_counts": res.graphlet_counts.tolist(),
        "refined": res.refined,
        "verified": int(len(res.verified_rows)),
    }
    if req.get("node_counts"):
        out["node_counts"] = res.node_counts.tolist()
    return out


def serve_lines(svc, rfile, wfile,
                large_threshold: int = LARGE_THRESHOLD) -> None:
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
            out = handle(svc, req, large_threshold)
        except Exception as e:  # the daemon survives bad requests
            out = {"id": rid, "error": f"{type(e).__name__}: {e}"}
        wfile.write(json.dumps(out) + "\n")
        wfile.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m desco_tpu_torch.serve")
    # several paths serve their ensemble
    ap.add_argument("--neigh_ckpt", required=True, nargs="+")
    ap.add_argument("--gossip_ckpt", default=None)
    ap.add_argument("--n_devices", type=int, default=1,
                    help=">1: data-parallel replicas for every forward "
                         "(-1: one per visible GPU)")
    ap.add_argument("--large_threshold", type=int, default=LARGE_THRESHOLD,
                    help="a request of one graph with at least this many "
                         "nodes is served by count_large_graph "
                         "(halo-sharded gossip)")
    ap.add_argument("--verify_budget", type=float, default=None)
    ap.add_argument("--exact_size", type=int, default=0,
                    help="serve queries with <= N nodes exactly")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 target tower (config serve_bf16)")
    ap.add_argument("--tcp", default=None, metavar="HOST:PORT",
                    help="serve line-JSON over TCP instead of stdio, one "
                         "connection at a time")
    ap.add_argument("--compile_cache", default=None, metavar="DIR",
                    help="build cache directory: restarts load the "
                         "kernels built there instead of recompiling")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without "
                         "a GPU unless 'cpu' is given)")
    args = ap.parse_args(argv)

    svc = build_service(args)
    print("ready", file=sys.stderr, flush=True)

    if args.tcp:
        import socket

        host, port = args.tcp.rsplit(":", 1)
        srv = socket.create_server((host, int(port)))
        print(f"listening on {args.tcp}", file=sys.stderr, flush=True)
        while True:
            conn, _ = srv.accept()
            with conn, conn.makefile("r") as rf, conn.makefile("w") as wf:
                serve_lines(svc, rf, wf, args.large_threshold)
    serve_lines(svc, sys.stdin, sys.stdout, args.large_threshold)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
