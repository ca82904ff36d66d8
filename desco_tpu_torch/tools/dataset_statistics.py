"""Dataset statistics: per-graph tables, per-neighborhood structural
features, a projection figure, and a trained-embedding projection.

    python -m desco_tpu_torch.tools.dataset_statistics --datasets Syn_64 \\
        ChemProxy [--depth 4] [--sample 2000] [--out output/stats] \\
        [--checkpoint release/r4/neigh.best] [--projection tsne|pca] \\
        [--device cpu]

The port of desco_tpu's ``analysis/dataset_statistics.py``, with its
flags, printed lines and CSVs (and ``--device``: the card by default).
For every dataset it builds the depth-d canonical neighborhoods, samples
``--sample`` of them (numpy seed 0), computes seven structural features
of each one's largest connected component (nodes, edges, average degree,
clustering, average shortest path, diameter, density; host numpy, copied
from the script), prints describe tables and writes
``graph_stats.csv`` and ``neighborhood_features.csv``. Then it projects
the standardized features to 2-D, and with ``--checkpoint`` also every
sampled neighborhood's pooled embedding from the trained SHMP tower
(``models/neighborhood.embed_targets``, the checkpoint's typing
settings).

The projections run in torch on the device, without sklearn:

- PCA is an SVD of the centered matrix (float64), each component's sign
  fixed as sklearn's ``svd_flip`` fixes it (the largest |loading|
  positive);
- t-SNE is exact and follows sklearn's: squared euclidean distances,
  the perplexity of each row found by bisection (float32 distances,
  float64 probabilities, tolerance 1e-5, 100 steps), the joint P, PCA
  initialization scaled to a first-column std of 1e-4, learning rate
  max(N / 12 / 4, 50), early exaggeration 12 with momentum 0.5 for 250
  iterations, then momentum 0.8 up to the script's 300, gains (+0.2 /
  x0.8, at least 0.01). Its final KL divergence is returned.

The figure is an SVG scatter, one color per dataset, written with the
standard library beside the ``.npy`` of the projection: the port runs
where matplotlib is not installed, and an SVG is text that needs no
plotting or image library.
"""

from __future__ import annotations

import argparse
import csv
import os
from xml.sax.saxutils import escape

import numpy as np

FEATS = ["num_nodes", "num_edges", "avg_degree", "clustering",
         "shortest_path_length", "diameter", "density"]
MACHINE_EPSILON = np.finfo(np.double).eps
# matplotlib's tab10 palette
TAB10 = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
         "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]


def _neigh_features(g) -> dict:
    """Seven structural features of one neighborhood graph's largest
    connected component. BFS-based, flat arrays; graphs here are <= a
    few hundred nodes."""
    indptr, indices = g.csr()
    n = g.n_nodes
    # largest connected component via BFS sweep
    comp = np.full(n, -1, np.int64)
    c = 0
    for s in range(n):
        if comp[s] >= 0:
            continue
        stack = [s]
        comp[s] = c
        while stack:
            v = stack.pop()
            for u in indices[indptr[v]:indptr[v + 1]]:
                if comp[u] < 0:
                    comp[u] = c
                    stack.append(int(u))
        c += 1
    sizes = np.bincount(comp)
    keep = int(np.argmax(sizes))
    nodes = np.nonzero(comp == keep)[0]
    nset = set(nodes.tolist())
    nn = len(nodes)
    deg = np.array([
        sum(1 for u in indices[indptr[v]:indptr[v + 1]] if int(u) in nset)
        for v in nodes], float)
    ne = int(deg.sum()) // 2

    # clustering coefficient (exact, sorted-adjacency intersection)
    cl = []
    adj = {int(v): set(int(u) for u in indices[indptr[v]:indptr[v + 1]]
                       if int(u) in nset) for v in nodes}
    for v in nodes:
        nb = adj[int(v)]
        k = len(nb)
        if k < 2:
            cl.append(0.0)
            continue
        links = sum(len(adj[u] & nb) for u in nb) // 2
        cl.append(2.0 * links / (k * (k - 1)))

    # all-pairs BFS for avg shortest path + diameter
    total, cnt, diam = 0, 0, 0
    order = {int(v): i for i, v in enumerate(nodes)}
    for v in nodes:
        dist = {int(v): 0}
        frontier = [int(v)]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for w in frontier:
                for u in adj[w]:
                    if u not in dist:
                        dist[u] = d
                        nxt.append(u)
            frontier = nxt
        for u, du in dist.items():
            if order[u] > order[int(v)]:
                total += du
                cnt += 1
                diam = max(diam, du)
    return {
        "num_nodes": nn,
        "num_edges": ne,
        "avg_degree": float(deg.mean()) if nn else 0.0,
        "clustering": float(np.mean(cl)) if cl else 0.0,
        "shortest_path_length": total / cnt if cnt else 0.0,
        "diameter": diam,
        "density": 2.0 * ne / (nn * (nn - 1)) if nn > 1 else 0.0,
    }


# ------------------------------------------------------------ projections
def pca(X, n_components: int, device):
    """[N, n_components] float64 PCA scores of X (numpy), sklearn's signs."""
    import torch

    x = torch.as_tensor(np.asarray(X, np.float64), device=device)
    xc = x - x.mean(0)
    _, _, vt = torch.linalg.svd(xc, full_matrices=False)
    # svd_flip(u_based_decision=False): each row's largest |entry| > 0
    rows = torch.arange(vt.shape[0], device=device)
    signs = torch.sign(vt[rows, vt.abs().argmax(1)])
    vt = vt * signs[:, None]
    return (xc @ vt[:n_components].T).cpu().numpy()


def pca2(X, device):
    """2-D PCA that degrades for tiny inputs: fewer components than two
    (one sample, one feature) are padded with zero columns."""
    nc = min(2, len(X), X.shape[1])
    if nc < 1:
        return np.zeros((len(X), 2))
    p = pca(X, nc, device)
    if p.shape[1] < 2:
        p = np.concatenate([p, np.zeros((len(p), 2 - p.shape[1]))], 1)
    return p


def joint_probabilities(X, perplexity: float, device):
    """sklearn's exact t-SNE P as a full [N, N] float64 tensor (zero
    diagonal; its upper triangle, row by row, is sklearn's condensed
    ``_joint_probabilities``)."""
    import torch

    x = torch.as_tensor(np.asarray(X, np.float64), device=device)
    n = x.shape[0]
    # euclidean_distances(squared=True), then sklearn's float32 cast
    sq = (x * x).sum(1)
    d = (sq[:, None] - 2.0 * (x @ x.T) + sq[None, :]).clamp(min=0.0)
    eye = torch.eye(n, dtype=torch.bool, device=device)
    d = d.masked_fill(eye, 0.0).float().double()
    target = float(np.log(perplexity))
    beta = torch.ones(n, dtype=torch.float64, device=device)
    lo = torch.full_like(beta, -np.inf)
    hi = torch.full_like(beta, np.inf)
    active = torch.ones(n, dtype=torch.bool, device=device)
    cond = torch.zeros_like(d)
    for _ in range(100):
        p = torch.exp(-d * beta[:, None]).masked_fill(eye, 0.0)
        s = p.sum(1)
        s = torch.where(s == 0.0, torch.full_like(s, 1e-8), s)
        p = p / s[:, None]
        diff = torch.log(s) + beta * (d * p).sum(1) - target
        cond = torch.where(active[:, None], p, cond)
        active = active & (diff.abs() > 1e-5)
        if not bool(active.any()):
            break
        up, down = active & (diff > 0), active & (diff <= 0)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(
            up, torch.where(torch.isinf(hi), beta * 2.0, (beta + hi) / 2.0),
            torch.where(down, torch.where(torch.isinf(lo), beta / 2.0,
                                          (beta + lo) / 2.0), beta))
    P = cond + cond.T
    P = (P / P.sum().clamp(min=MACHINE_EPSILON)).clamp(min=MACHINE_EPSILON)
    return P.masked_fill(eye, 0.0)


def _kl_and_grad(Y, P, off):
    """sklearn's exact ``_kl_divergence`` (one degree of freedom) over a
    full symmetric P: the KL divergence and its gradient [N, 2]."""
    import torch

    diff = Y[:, None, :] - Y[None, :, :]
    w = (1.0 / (1.0 + (diff * diff).sum(-1))) * off
    Q = (w / w.sum()).clamp(min=MACHINE_EPSILON) * off
    kl = (P * torch.log(P.clamp(min=MACHINE_EPSILON)
                        / Q.clamp(min=MACHINE_EPSILON))).sum()
    pqd = (P - Q) * w
    grad = 4.0 * (pqd.sum(1)[:, None] * Y - pqd @ Y)
    return kl, grad


def _descend(Y, P, off, it: int, max_iter: int, momentum: float,
             n_iter_without_progress: int, lr: float):
    """sklearn's ``_gradient_descent``: gains, momentum, a progress check
    every 50 iterations."""
    import torch

    update = torch.zeros_like(Y)
    gains = torch.ones_like(Y)
    error = best_error = float(np.finfo(float).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % 50 == 0
        kl, grad = _kl_and_grad(Y, P, off)
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp(min=0.01)
        grad = grad * gains
        update = momentum * update - lr * grad
        Y = Y + update
        if check or i == max_iter - 1:
            error = float(kl)
        if check:
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if float(torch.linalg.norm(grad)) <= 1e-7:
                break
    return Y, error, i


def tsne(X, perplexity: float, device, max_iter: int = 300):
    """(embedding [N, 2] float32, final KL divergence) of an exact t-SNE
    following sklearn's (module docstring)."""
    import torch

    n = len(X)
    P = joint_probabilities(X, perplexity, device)
    off = 1.0 - torch.eye(n, dtype=torch.float64, device=device)
    init = pca(X, 2, device).astype(np.float32)
    init = init / np.std(init[:, 0]) * 1e-4
    Y = torch.as_tensor(init, device=device).double()
    lr = max(n / 12.0 / 4.0, 50.0)
    Y, kl, it = _descend(Y, P * 12.0, off, 0, 250, 0.5, 250, lr)
    if it < 250 or max_iter - 250 > 0:
        Y, kl, it = _descend(Y, P, off, it + 1, max_iter, 0.8, 300, lr)
    return Y.float().cpu().numpy(), kl


def write_svg(path: str, proj: np.ndarray, labels, title: str) -> None:
    """A scatter of ``proj`` [N, 2], one tab10 color per label, with a
    legend and a title."""
    w, h, m = 1000, 700, 40
    x, y = proj[:, 0], proj[:, 1]
    x0, x1 = (float(x.min()), float(x.max())) if len(x) else (0.0, 1.0)
    y0, y1 = (float(y.min()), float(y.max())) if len(y) else (0.0, 1.0)
    sx = (w - 2 * m) / max(x1 - x0, 1e-12)
    sy = (h - 2 * m) / max(y1 - y0, 1e-12)
    lab = np.asarray(labels)
    out = ['<?xml version="1.0" encoding="UTF-8"?>',
           f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
           f'height="{h}" viewBox="0 0 {w} {h}">',
           '<rect width="100%" height="100%" fill="white"/>',
           f'<text x="{w / 2}" y="24" text-anchor="middle" '
           f'font-family="sans-serif" font-size="16">{escape(title)}</text>']
    for i, name in enumerate(sorted(set(labels))):
        color = TAB10[i % 10]
        out.append(f'<g fill="{color}" fill-opacity="0.5">')
        for px, py in proj[lab == name]:
            out.append(f'<circle cx="{m + (px - x0) * sx:.2f}" '
                       f'cy="{h - m - (py - y0) * sy:.2f}" r="2"/>')
        out.append("</g>")
        ly = 44 + 18 * i
        out.append(f'<circle cx="{w - 150}" cy="{ly}" r="5" '
                   f'fill="{color}"/><text x="{w - 140}" y="{ly + 4}" '
                   f'font-family="sans-serif" font-size="12">'
                   f'{escape(str(name))}</text>')
    out.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def _project_and_plot(X, labels, args, tag, device, log) -> dict:
    kl = None
    if args.projection == "tsne":
        # the script's perplexity 40, clamped to [2, n-1) for tiny samples
        perp = max(2, min(40, (len(X) - 1) // 4))
        if len(X) <= perp + 1:
            proj = pca2(X, device)
        else:
            proj, kl = tsne(X, perp, device)
    else:
        proj = pca2(X, device)
    path = os.path.join(args.out, f"{args.projection}_{tag}.svg")
    write_svg(path, proj, labels, f"{args.projection} of {tag}")
    np.save(os.path.join(args.out, f"{args.projection}_{tag}.npy"), proj)
    log(f"wrote {path}")
    return {"proj": proj, "kl": kl, "svg": path}


def trained_embeddings(args, neighs_by_ds, device):
    """Each sampled neighborhood's pooled embedding from a trained SHMP
    tower, batched through the packed pipeline, with the checkpoint's
    edge typing and features (its hetero / tconv / order / input width /
    node-feature / degree-feature settings)."""
    import torch

    from ..batch.build import (homogeneous_neighborhood_sample,
                               neighborhood_sample)
    from ..batch.packed import auto_capacities, pack_samples
    from ..models import neighborhood as neigh_mod
    from ..pipeline import apply_degree_feature, model_configs
    from ..serving import _rehydrate_config
    from ..train.checkpoint import load_checkpoint

    params, meta = load_checkpoint(args.checkpoint)
    cfg = _rehydrate_config(meta, None)
    tgt_cfg, _ = model_configs(cfg, device)
    params = params.requires_grad_(False).to(device)

    def one_sample(nb):
        if not cfg.use_hetero:
            return homogeneous_neighborhood_sample(nb)
        feat = nb.graph.node_feat if cfg.use_node_feature else None
        return neighborhood_sample(nb, use_tconv=cfg.use_tconv,
                                   f_dim=cfg.neigh_input_dim, x=feat,
                                   order=cfg.order)

    out, labels = [], []
    for name, neighs in neighs_by_ds.items():
        samples = [one_sample(nb) for nb in neighs]
        if cfg.degree_feature:
            apply_degree_feature(samples)
        caps = auto_capacities(samples, g_cap=256)
        for b in pack_samples(samples, *caps):
            with torch.inference_mode():
                emb = neigh_mod.embed_targets(params, tgt_cfg, b.to(device))
            valid = np.asarray(b.graph_mask) > 0
            out.append(emb.float().cpu().numpy()[valid])
            labels += [name] * int(valid.sum())
    return np.concatenate(out, 0), labels


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.tools.dataset_statistics")
    p.add_argument("--datasets", type=str, nargs="+", default=["Syn_64"])
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--sample", type=int, default=2000,
                   help="neighborhoods sampled per dataset (fixed seed)")
    p.add_argument("--out", type=str, default="output/stats")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="SHMP checkpoint: also project TRAINED "
                        "neighborhood embeddings")
    p.add_argument("--projection", choices=["tsne", "pca"],
                   default="tsne")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p


def run(args, log=print) -> dict:
    """Returns the rows of both CSVs, the feature matrix and each
    projection (with its KL divergence for t-SNE)."""
    from ..data.datasets import load_data
    from ..graph.canonical import extract_all_neighborhoods
    from ..utils.device import device_label, resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(0)
    log(f"device: {device_label(device)}")

    # ---- per-GRAPH summary table (the quick view)
    graph_rows, feat_rows, neighs_by_ds = [], [], {}
    for name in args.datasets:
        graphs = load_data(name, args.data_root)
        nodes = np.array([g.n_nodes for g in graphs])
        edges = np.array([g.n_edges for g in graphs])
        degs = np.concatenate([g.degrees() for g in graphs])
        graph_rows.append({
            "dataset": name, "graphs": len(graphs),
            "nodes_mean": float(nodes.mean()), "nodes_max": int(nodes.max()),
            "edges_mean": float(edges.mean()), "edges_max": int(edges.max()),
            "degree_mean": float(degs.mean()), "degree_max": int(degs.max()),
        })
        log("  ".join(f"{k}={v}" for k, v in graph_rows[-1].items()))

        # ---- per-NEIGHBORHOOD structural features (sampled)
        neighs, _, _ = extract_all_neighborhoods(graphs, depth=args.depth)
        idx = rng.permutation(len(neighs))[:args.sample]
        neighs_by_ds[name] = [neighs[i] for i in idx]
        for nb in neighs_by_ds[name]:
            row = _neigh_features(nb.graph)
            row["dataset"] = name
            feat_rows.append(row)

    with open(os.path.join(args.out, "graph_stats.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(graph_rows[0].keys()))
        w.writeheader()
        w.writerows(graph_rows)
    with open(os.path.join(args.out, "neighborhood_features.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=["dataset"] + FEATS)
        w.writeheader()
        w.writerows(feat_rows)

    for name in args.datasets:
        sel = [r for r in feat_rows if r["dataset"] == name]
        log(f"\n{name}: {len(sel)} neighborhoods")
        for ft in FEATS:
            v = np.array([r[ft] for r in sel], float)
            log(f"  {ft:22s} mean {v.mean():9.3f}  std {v.std():9.3f}"
                f"  min {v.min():8.3f}  max {v.max():8.3f}")

    # ---- projection over structural features
    X = np.array([[r[ft] for ft in FEATS] for r in feat_rows], float)
    labels = [r["dataset"] for r in feat_rows]
    Xn = (X - X.mean(0)) / np.maximum(X.std(0), 1e-9)
    out = {"device": device_label(device), "graph_rows": graph_rows,
           "feat_rows": feat_rows, "features": Xn,
           "neighborhood_features": _project_and_plot(
               Xn, labels, args, "neighborhood_features", device, log)}

    # ---- trained-embedding projection
    if args.checkpoint:
        emb, elabels = trained_embeddings(args, neighs_by_ds, device)
        out["embeddings"] = emb
        out["trained_embeddings"] = _project_and_plot(
            emb, elabels, args, "trained_embeddings", device, log)
    return out


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
