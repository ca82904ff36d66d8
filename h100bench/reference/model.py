"""DeSCo's models and serving pipeline in plain PyTorch, written from the
equations (a frozen restatement of the program's plain arithmetic, with
none of its kernels, packing or compiled forwards), over the unpadded
``graphs.Batch`` unions.

SHMP tower: per layer the typed messages of the configuration's layer
(``convs/<conv_type>.py``: SAGE, GAT) summed over the edge types, the
bias sum of the types into each node, the layer's update, a ReLU.
Then the concat of every layer's h (and the input), the anchor MLP
(LeakyReLU 0.1) on canonical nodes, a sum per graph and the post MLP.
The count head: log2(count + 1) = MLP([target embedding, query
embedding]). Bounds: spanning-tree homomorphism counts rooted at the
canonical node against the subset bound, over |Aut(Q)|. Gossip: a
two-layer gated GNN per query over the whole graph, on the stage-1
counts, adding a residual.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import convs
from .graphs import Batch
from .queries import QUERIES

# destination node type of each target edge type (0 count, 1 canonical)
TARGET_DST = (0, 0, 1, 1, 0, 0)
QUERY_DST = (0, 0)


# the control's precision: every product's operands rounded to TF32 (8
# exponent bits, 10 mantissa bits, to nearest even), f32 accumulation;
# set through ``pipeline.precision``
TF32 = {"on": False}


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest
    even."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    bits = (bits + 0x0FFF + keep) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the reference's precision (float32, or the control's
    TF32)."""
    if TF32["on"]:
        # rounded in the forward; the gradient passes the rounding as is
        a = a + (to_tf32(a.detach()) - a.detach())
        b = b + (to_tf32(b.detach()) - b.detach())
    return a @ b


def type_sum(values: torch.Tensor, index: torch.Tensor, n: int):
    out = values.new_zeros((n,) + values.shape[1:])
    return out.index_add_(0, index, values)


def per_type(x, w, b, ntype):
    """x[i] @ w[type(i)] + b[type(i)]."""
    out = x.new_zeros(x.shape[0], w.shape[-1])
    for t in range(w.shape[0]):
        idx = torch.nonzero(ntype == t)[:, 0]
        out = out.index_put((idx,), mm(x[idx], w[t]) + b[t])
    return out


def tower(w: Dict[str, torch.Tensor], prefix: str, conv: str,
          b: Batch, dst_types: Sequence[int]) -> torch.Tensor:
    """[G, H] embeddings of one SHMP tower."""
    pre_w, pre_b = w[f"{prefix}/pre/0"], w[f"{prefix}/pre/1"]
    conv_w, conv_b = w[f"{prefix}/conv/0"], w[f"{prefix}/conv/1"]
    n_layers, n_types = conv_w.shape[0], conv_w.shape[1]
    h = per_type(b.x, pre_w, pre_b, b.ntype)
    embs = [h]
    layer_mod = convs.load(conv)
    for layer in range(n_layers):
        msg = h.new_zeros(b.n, h.shape[1])
        for t in range(n_types):
            sel = b.etype == t
            msg = msg + layer_mod.message(w, prefix, layer, t, h,
                                          b.src[sel], b.dst[sel], b.n)
        bias = torch.stack([
            conv_b[layer, [t for t, d in enumerate(dst_types)
                           if d == nt]].sum(dim=0)
            for nt in range(max(dst_types) + 1)])
        msg = msg + bias[b.ntype]
        h = layer_mod.update(w, prefix, layer, msg, h, b.ntype)
        h = torch.relu(h)
        embs.append(h)
    emb = torch.cat(embs, dim=1)
    anchored = F.leaky_relu(mm(emb, w[f"{prefix}/anchor/0"])
                            + w[f"{prefix}/anchor/1"], 0.1)
    emb = torch.where((b.ntype == 1)[:, None], anchored, emb)
    pooled = type_sum(emb, b.graph, b.n_graphs)
    x = mm(pooled, w[f"{prefix}/post/0/0"]) + w[f"{prefix}/post/0/1"]
    x = F.leaky_relu(x, 0.1)
    x = torch.relu(mm(x, w[f"{prefix}/post/1/0"]) + w[f"{prefix}/post/1/1"])
    x = torch.relu(mm(x, w[f"{prefix}/post/2/0"]) + w[f"{prefix}/post/2/1"])
    return mm(x, w[f"{prefix}/post/3/0"]) + w[f"{prefix}/post/3/1"]


def count_head(w, emb_t: torch.Tensor, emb_q: torch.Tensor,
               with_scale: bool = False):
    """[G, Q] predicted log2(count + 1); ``with_scale`` also returns the
    sum of the absolute terms of the last product (the size of what the
    prediction was summed from)."""
    g, q = emb_t.shape[0], emb_q.shape[0]
    pair = torch.cat([emb_t[:, None, :].expand(g, q, -1),
                      emb_q[None, :, :].expand(g, q, -1)], dim=2)
    hid = F.leaky_relu(mm(pair, w["count1/0"]) + w["count1/1"], 0.01)
    pred = (mm(hid, w["count2/0"]) + w["count2/1"])[..., 0]
    if not with_scale:
        return pred
    return pred, (hid.abs() @ w["count2/0"].abs())[..., 0] + \
        w["count2/1"].abs()


def predict_log_counts(w, conv: str, targets: Batch,
                       queries: Batch) -> torch.Tensor:
    emb_q = tower(w, "query", conv, queries, QUERY_DST)
    emb_t = tower(w, "target", conv, targets, TARGET_DST)
    return count_head(w, emb_t, emb_q)


def smooth_l1(d: torch.Tensor) -> torch.Tensor:
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def train_loss(w, conv: str, targets: Batch, queries: Batch,
               y: torch.Tensor, rows: int = None) -> torch.Tensor:
    """Smooth-L1 between the predicted and the true log2(count + 1),
    averaged over the graphs per query and then over the queries
    (``rows``: over the first graphs only)."""
    pred = predict_log_counts(w, conv, targets, queries)
    loss = smooth_l1(pred - torch.log2(y + 1.0))
    return loss[:rows].mean(dim=0).mean()


def adam_steps(w0: Dict[str, torch.Tensor], grads_of, n_steps: int,
               lr: float, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8):
    """Adam (no weight decay) for ``n_steps``: ``grads_of(w, step) ->
    (loss, {key: grad})``. Returns (losses, first gradients, weights
    after the steps)."""
    w = {k: v.clone() for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, first = [], None
    for step in range(1, n_steps + 1):
        loss, g = grads_of(w, step - 1)
        losses.append(float(loss))
        if first is None:
            first = g
        for k in w:
            mu[k] = b1 * mu[k] + (1 - b1) * g[k]
            nu[k] = b2 * nu[k] + (1 - b2) * g[k] * g[k]
            m_hat = mu[k] / (1 - b1 ** step)
            v_hat = nu[k] / (1 - b2 ** step)
            w[k] = w[k] - lr * m_hat / (torch.sqrt(v_hat) + eps)
    return losses, first, w


# ---------------------------------------------------------------- bounds
def _spanning_tree(n: int, edges) -> List[Tuple[int, int]]:
    """BFS tree from node 0, neighbors in ascending order: (child,
    parent) edges."""
    adj = [sorted({b for a, b in edges if a == u}
                  | {a for a, b in edges if b == u}) for u in range(n)]
    seen, order, out = {0}, [0], []
    for u in order:
        for v in adj[u]:
            if v not in seen:
                seen.add(v)
                order.append(v)
                out.append((v, u))
    return out


def _automorphisms(n: int, edges) -> int:
    es = {frozenset(e) for e in edges}
    return sum(1 for p in itertools.permutations(range(n))
               if {frozenset((p[a], p[b])) for a, b in edges} == es)


def _rooted_homs(tree, root: int, n: int, adj_mul) -> torch.Tensor:
    """hom(T -> G) with T's ``root`` on each node of G, by the tree DP:
    h[u] = prod over children c of (A h[c])."""
    nbrs = {u: [] for u in range(n)}
    for a, b in tree:
        nbrs[a].append(b)
        nbrs[b].append(a)

    def h(u, parent):
        out = None
        for c in nbrs[u]:
            if c == parent:
                continue
            term = adj_mul(h(c, u))
            out = term if out is None else out * term
        return out if out is not None else adj_mul.ones

    return h(root, -1)


class _Adj:
    def __init__(self, b: Batch, dtype):
        self.src, self.dst, self.n = b.src, b.dst, b.n
        self.ones = torch.ones(b.n, dtype=dtype, device=b.src.device)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return v.new_zeros(self.n).index_add_(0, self.dst, v[self.src])


def count_bounds(b: Batch) -> torch.Tensor:
    """[G, Q] float64 upper bounds of the canonical counts of each
    neighborhood sample of ``b``."""
    adj = _Adj(b, torch.float64)
    canon = b.ntype == 1
    canon_graph = b.graph[canon]
    sizes = torch.bincount(b.graph, minlength=b.n_graphs).double()
    cols = []
    for _, k, edges in QUERIES:
        tree = _spanning_tree(k, edges)
        tot = sum(_rooted_homs(tree, r, k, adj) for r in range(k))
        tree_b = torch.zeros(b.n_graphs, dtype=torch.float64,
                             device=b.src.device)
        tree_b[canon_graph] = tot[canon]
        m = sizes - 1
        subset = torch.tensor([math.comb(int(v), k - 1) for v in m.tolist()],
                              dtype=torch.float64, device=b.src.device)
        subset = subset * math.factorial(k)
        cols.append(torch.minimum(tree_b, subset)
                    / _automorphisms(k, edges))
    return torch.stack(cols, dim=1)


# ---------------------------------------------------------------- gossip
def gossip(w: Dict[str, torch.Tensor], g: Batch, counts: torch.Tensor,
           emb_q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(refined counts [N, Q], scales [N, Q]) of the gossip stage, the
    scale |stage-1 count| + the sum of the absolute terms of the
    residual's last product:
    ``counts`` [N, Q] the stage-1 counts on the graphs' nodes (0 where a
    node's neighborhood was dropped), ``emb_q`` [Q, H] the query
    embeddings. Edge type 0 is a forward edge (src < dst)."""
    n_layers = len({k.split("/")[1] for k in w if k.startswith("convs/")})
    fwd = (g.etype == 0).to(counts.dtype)
    deg = torch.stack([type_sum(fwd, g.dst, g.n),
                       type_sum(1.0 - fwd, g.dst, g.n)], dim=1)
    res, size = [], []
    for q in range(emb_q.shape[0]):
        qe = emb_q[q]
        x = mm(counts[:, q:q + 1], w["pre/0"]) + w["pre/1"]
        x = torch.cat([qe[None, :].expand(g.n, -1), x], dim=1)
        embs = [x]
        for layer in range(n_layers):
            p = f"convs/{layer}"
            gate = torch.sigmoid(mm(qe[None], w[f"{p}/gate/0/0"])[0]
                                 + w[f"{p}/gate/0/1"])
            gate = F.leaky_relu(torch.sigmoid(
                mm(gate[None], w[f"{p}/gate/1/0"])[0]
                + w[f"{p}/gate/1/1"]))[0]
            wt = gate * fwd + (1.0 - gate) * (1.0 - fwd)
            mixed = type_sum(wt[:, None] * x[g.src], g.dst, g.n)
            wdeg = gate * deg[:, 0] + (1.0 - gate) * deg[:, 1]
            aggr = mm(mixed, w[f"{p}/com/0"]) + wdeg[:, None] * w[f"{p}/com/1"]
            x = torch.relu(mm(torch.cat([aggr, x], dim=1), w[f"{p}/upd/0"])
                           + w[f"{p}/upd/1"])
            embs.append(x)
        h = mm(torch.cat(embs, dim=1), w["post/0/0"]) + w["post/0/1"]
        h = F.leaky_relu(h, 0.1)
        h = torch.relu(mm(h, w["post/1/0"]) + w["post/1/1"])
        h = torch.relu(mm(h, w["post/2/0"]) + w["post/2/1"])
        res.append((mm(h, w["post/3/0"]) + w["post/3/1"])[:, 0])
        size.append((h.abs() @ w["post/3/0"].abs())[:, 0]
                    + w["post/3/1"].abs())
    r = torch.stack(res, dim=1)
    return counts + r, counts.abs() + torch.stack(size, dim=1)
