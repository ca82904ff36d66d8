"""The reference's two runs: a served request's counts, and the first
training steps. Both take the graphs and weights the benchmark made and
nothing the program made; ``tf32`` computes the same in TF32 (the
control, a step below float32 with TF32 off)."""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import graphs as rg
from . import model as rm

BLOCK = 4096  # neighborhoods per block of the reference's forward


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 with TF32 off (the configuration's precision), or the
    control's TF32 products (``model.mm``)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, rm.TF32["on"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rm.TF32["on"] = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, rm.TF32["on"]) = saved


def serve(graphs: Sequence[Tuple[int, np.ndarray]],
          w_neigh: Dict[str, torch.Tensor], w_gossip: Dict[str, torch.Tensor],
          conv: str, depth: int, device, tf32: bool = False,
          gossip_input=None) -> dict:
    """The served pipeline without the exact tail: stage-1 counts of
    every canonical neighborhood clamped to its bound, gossip over the
    whole graphs, the node counts clamped to [0, bound]. ``gossip_input``
    [K, Q], when given, takes the place of the stage-1 counts as the
    gossip stage's input (the stage followed from another run's stage 1).
    Returns numpy arrays: ``stage1`` [K, Q] (always the reference's own)
    and ``stage1_scale`` [K, Q] (the size of what each prediction was
    summed from, ``model.count_head``), ``node`` [N, Q] and ``scale``
    [N, Q] (``model.gossip``)."""
    with precision(tf32), torch.no_grad():
        dec = rg.decompose(graphs, depth, device)
        emb_q = rm.tower(w_neigh, "query", conv, rg.query_batch(device),
                         rm.QUERY_DST)
        stage1, sizes, bounds = [], [], []
        for lo in range(0, len(dec.index), BLOCK):
            rows = range(lo, min(lo + BLOCK, len(dec.index)))
            b = rg.neighborhood_batch(dec, rows, device)
            emb_t = rm.tower(w_neigh, "target", conv, b, rm.TARGET_DST)
            pred, size = rm.count_head(w_neigh, emb_t, emb_q, True)
            ub = rm.count_bounds(b)
            stage1.append(torch.minimum(torch.exp2(pred).double() - 1.0,
                                        ub))
            sizes.append(size)
            bounds.append(ub)
        stage1 = torch.cat(stage1)
        sizes = torch.cat(sizes)
        bounds = torch.cat(bounds)
        offsets = np.concatenate([[0], np.cumsum([n for n, _ in graphs])])
        node_rows = torch.as_tensor(
            offsets[dec.index[:, 0]] + dec.index[:, 1], device=device)
        n_total, n_q = int(offsets[-1]), stage1.shape[1]
        x = torch.zeros(n_total, n_q, dtype=torch.float32, device=device)
        x[node_rows] = (stage1.float() if gossip_input is None else
                        torch.as_tensor(np.asarray(gossip_input),
                                        dtype=torch.float32, device=device))
        out, scale = rm.gossip(w_gossip, rg.graph_batch(graphs, device),
                               x, emb_q)
        node = torch.zeros(n_total, n_q, dtype=torch.float64, device=device)
        node[node_rows] = torch.minimum(out[node_rows].double().clamp(min=0),
                                        bounds)
    return {k: v.cpu().numpy() for k, v in (
        ("stage1", stage1), ("stage1_scale", sizes), ("node", node),
        ("scale", scale))}


def train(graphs: Sequence[Tuple[int, np.ndarray]], labels: np.ndarray,
          w0: Dict[str, torch.Tensor], conv: str, depth: int, caps: tuple,
          batch_order: Sequence[int], lr: float, device,
          tf32: bool = False, half: bool = False) -> dict:
    """Adam steps over the batches ``batch_order`` of the graphs'
    canonical neighborhoods, cut into batches as ``graphs.greedy_batches``
    cuts them at ``caps`` (n_cap, e_cap, g_cap). ``labels`` [N, Q]: each
    node's counts, the label of its neighborhood. Returns ``losses``,
    ``grad`` (the first step's gradients), ``delta`` (the weights' change
    over the steps), as {key: tensor} on ``device``, and ``n_batches``.
    ``half`` (a fault, for the limits): each step's loss leaves out the
    second half of its batch and takes the mean over the rest."""
    with precision(tf32):
        dec = rg.decompose(graphs, depth, device)
        cuts = rg.greedy_batches(dec.n_nodes, dec.n_edges, *caps)
        offsets = np.concatenate([[0], np.cumsum([n for n, _ in graphs])])
        qb = rg.query_batch(device)
        feeds = []
        for bi in batch_order:
            rows = list(range(*cuts[bi]))
            b = rg.neighborhood_batch(dec, rows, device)
            node = offsets[dec.index[rows, 0]] + dec.index[rows, 1]
            y = torch.as_tensor(labels[node], dtype=torch.float32,
                                device=device)
            feeds.append((b, y))

        def grads_of(w, step):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in w.items()}
            b, y = feeds[step]
            loss = rm.train_loss(leaves, conv, b, qb, y,
                                 b.n_graphs // 2 if half else None)
            keys = list(leaves)
            gs = torch.autograd.grad(loss, [leaves[k] for k in keys],
                                     allow_unused=True)
            return loss.detach(), {
                k: (g if g is not None else torch.zeros_like(leaves[k]))
                for k, g in zip(keys, gs)}

        losses, grad, w3 = rm.adam_steps(w0, grads_of, len(feeds), lr)
    return {"losses": losses, "grad": grad,
            "delta": {k: w3[k] - w0[k] for k in w0},
            "n_batches": len(cuts)}
