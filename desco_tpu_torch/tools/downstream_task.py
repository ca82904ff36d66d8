"""Downstream utility of counts: node classification.

    python -m desco_tpu_torch.tools.downstream_task --dataset Syn_64
        [--pred_csv output/.../gossip_node_<ds>_results.csv] [--device cpu]

The port of desco_tpu's ``experimental/downstream_task.py``, with its
flags and printed lines (and ``--device``: the card by default). A small
MLP (``models/init.mlp_params`` [F, 64, 64, 2], ReLU) classifies whether
a node's triangle count is above the dataset's median from its other
size-3/4/5 canonical counts (log2(count + 1)): with the exact counts,
and with ``main``'s predicted node counts when ``--pred_csv`` names the
node CSV ``main`` writes. Full-batch training on the device with the
port's Adam (lr 1e-3) on the softmax cross-entropy, a 70 / 30 split
from numpy seed 0, the MLP's weights from ``torch.Generator`` seed 0.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m desco_tpu_torch.tools.downstream_task")
    p.add_argument("--dataset", type=str, default="Syn_64")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--pred_csv", type=str, default=None,
                   help="node-level predicted counts CSV (from main)")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p


def classify(features: np.ndarray, y: np.ndarray, epochs: int, device,
             init=None) -> float:
    """Test accuracy of the MLP on ``features`` (counts). ``init``: the
    MLP's initial [(w, b), ...] as numpy arrays."""
    import torch
    import torch.nn.functional as F

    from ..models.init import Linear, mlp_params
    from ..train.loop import make_adam

    x = np.log2(features.astype(np.float64) + 1).astype(np.float32)
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(x))
    split = int(0.7 * len(x))
    tr, te = perm[:split], perm[split:]

    if init is None:
        params = mlp_params([x.shape[1], 64, 64, 2],
                            generator=torch.Generator().manual_seed(0))
    else:
        params = torch.nn.ModuleList([
            Linear(torch.tensor(np.asarray(w, np.float32)),
                   torch.tensor(np.asarray(b, np.float32)))
            for w, b in init])
    params = params.to(device)

    def forward(h):
        h = torch.relu(params[0](h))
        h = torch.relu(params[1](h))
        return params[2](h)

    opt = make_adam(params)
    xt = torch.as_tensor(x[tr], device=device)
    yt = torch.as_tensor(y[tr], dtype=torch.long, device=device)
    for _ in range(epochs):
        opt.zero_grad()
        F.cross_entropy(forward(xt), yt).backward()
        opt.step(1e-3)
    with torch.no_grad():
        pred = forward(torch.as_tensor(x[te], device=device)).argmax(-1)
    return float((pred.cpu().numpy() == y[te]).mean())


def run(args, init=None, log=print) -> dict:
    """Returns the labels, the exact features and the accuracies."""
    from ..data.datasets import load_data
    from ..data.workload import Workload
    from ..graph.atlas import gen_query_ids
    from ..utils.device import device_label, resolve_device

    device = resolve_device(args.device)
    graphs = load_data(args.dataset, args.data_root)
    wl = Workload(graphs, root=f"{args.data_root}/{args.dataset}",
                  name=args.dataset)
    truth = wl.compute_groundtruth(gen_query_ids([3, 4, 5]))

    # label: triangle count above median (query index 1 = triangle)
    y = (truth[:, 1] > np.median(truth[:, 1])).astype(np.int32)
    # exclude the label query (index 1) from the features
    feat_cols = [i for i in range(truth.shape[1]) if i != 1]
    log(f"device: {device_label(device)}")
    out = {"device": device_label(device), "labels": y,
           "features": truth[:, feat_cols]}
    for tag, feats in [("exact", truth[:, feat_cols])] + (
            [("predicted", np.loadtxt(args.pred_csv, delimiter=",",
                                      skiprows=1)[:, 1:][:, feat_cols])]
            if args.pred_csv else []):
        acc = classify(feats, y, args.epochs, device, init)
        log(f"node-classification acc with {tag} counts: {acc:.4f}")
        out[f"acc_{tag}"] = acc
    return out


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
