"""LRP baseline: Local Relational Pooling — the port of
``desco_tpu/models/lrp.py``.

Per node, egonet permutation sequences (the node, then up to ``width``
ordered neighbours: subtensors of ``sub_len`` slots), a learned
[h, h, S * S] contraction per permutation, mean-pooling back to the
nodes and a degree-factor MLP. Since the edge feature is a constant
vector, a permutation's [S, S, h] tensor is determined by its node ids
(``perm_nodes`` [P, S], -1 pad) and the adjacency among them
(``perm_adj`` [P, S, S]); the contraction splits exactly into a diagonal
term (node features) and an off-diagonal term (the edge vector times the
adjacency), two einsums, so the [P, S * S * h] tensor is never built.

The host side (the permutation arrays) is desco_tpu's numpy and
itertools code; the device side is plain PyTorch (einsum, gathers and
``index_add_`` for the segment sums: desco_tpu runs these through XLA,
no Pallas kernel).
"""

from __future__ import annotations

import dataclasses
from itertools import permutations
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..graph.container import Graph
from ..ops.segment import segment_sum
from .init import Tree, linear_params


@dataclasses.dataclass(frozen=True)
class LRPConfig:
    sub_len: int = 4           # subtensor length S (perm slots)
    width: int = 3             # ordered neighbors per sequence
    hid_dim: int = 16
    num_layers: int = 4
    num_tasks: int = 29
    input_dim: int = 1

    @property
    def lrp_length(self) -> int:
        return self.sub_len * self.sub_len


# ----------------------------------------------------------------- host
def lrp_permutations(
    g: Graph, sub_len: int = 4, width: int = 3,
    max_perms_per_node: int = 1024,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(perm_nodes [P, S], perm_adj [P, S, S], perm_owner [P]).

    Per node v: sequences [v] + ordered <=width-subsets of neighbors
    (seq_generate_deep with depth=1, LRP_dataset.py:315-348). Pads with
    -1; ``max_perms_per_node`` truncates pathological hubs (the
    reference drops whole graphs over a threshold instead)."""
    indptr, indices = g.csr()
    pn, pa, po = [], [], []
    for v in range(g.n_nodes):
        nbrs = [int(u) for u in indices[indptr[v]:indptr[v + 1]]]
        k = min(width, len(nbrs))
        count = 0
        for p in permutations(nbrs, k):
            seq = [v] + list(p)
            seq = seq[:sub_len]
            row = np.full(sub_len, -1, np.int32)
            row[:len(seq)] = seq
            pn.append(row)
            po.append(v)
            count += 1
            if count >= max_perms_per_node:
                break
        if count == 0:
            row = np.full(sub_len, -1, np.int32)
            row[0] = v
            pn.append(row)
            po.append(v)
    perm_nodes = np.stack(pn)
    perm_owner = np.array(po, np.int32)
    # adjacency pattern among perm slots
    adj = np.zeros((g.n_nodes, g.n_nodes), bool)
    if g.n_edges:
        adj[g.edges[:, 0], g.edges[:, 1]] = True
        adj[g.edges[:, 1], g.edges[:, 0]] = True
    s = sub_len
    pi = perm_nodes[:, :, None]
    pj = perm_nodes[:, None, :]
    valid = (pi >= 0) & (pj >= 0)
    perm_adj = np.zeros((len(pn), s, s), bool)
    np_i = np.clip(pi, 0, None)
    np_j = np.clip(pj, 0, None)
    perm_adj = valid & adj[np_i, np_j]
    return perm_nodes, perm_adj.astype(np.float32), perm_owner


def lrp_arrays_for_batch(batch, cfg: LRPConfig,
                         max_perms_per_node: int = 60,
                         p_cap: int = 0):
    """Host: permutation arrays for a PackedGraphs whole-graph batch,
    indexing batch-local node ids. Returns (perm_nodes [P, S],
    perm_adj [P, S, S], perm_owner [P] (-1 pad), degs [N]).

    ``max_perms_per_node`` truncates hubs (LRP is O(deg^width); the
    reference instead DROPS whole graphs above a perm threshold,
    LRP_dataset.py filter_threshold)."""
    es = np.asarray(batch.edge_src)
    ed = np.asarray(batch.edge_dst)
    nm = np.asarray(batch.node_mask) > 0
    real = nm[es] & nm[ed] & (es != ed)
    n = batch.n_cap
    degs = np.bincount(es[real], minlength=n).astype(np.float32)

    # sorted adjacency via argsort on src
    order = np.argsort(es[real], kind="stable")
    s_src, s_dst = es[real][order], ed[real][order]
    indptr = np.searchsorted(s_src, np.arange(n + 1))

    pn, po = [], []
    s, w = cfg.sub_len, cfg.width
    for v in np.nonzero(nm)[0]:
        nbrs = np.unique(s_dst[indptr[v]:indptr[v + 1]])
        k = min(w, len(nbrs))
        cnt = 0
        for p in permutations(nbrs.tolist(), k):
            row = np.full(s, -1, np.int32)
            seq = ([int(v)] + list(p))[:s]
            row[:len(seq)] = seq
            pn.append(row)
            po.append(int(v))
            cnt += 1
            if cnt >= max_perms_per_node:
                break
        if cnt == 0:
            row = np.full(s, -1, np.int32)
            row[0] = int(v)
            pn.append(row)
            po.append(int(v))
    perm_nodes = np.stack(pn) if pn else np.full((1, s), -1, np.int32)
    perm_owner = np.array(po, np.int32) if po else np.array([-1], np.int32)

    # vectorized adjacency pattern via sorted edge keys
    edge_keys = np.sort(s_src.astype(np.int64) * n + s_dst)
    pi = perm_nodes[:, :, None].astype(np.int64)
    pj = perm_nodes[:, None, :].astype(np.int64)
    valid = (pi >= 0) & (pj >= 0)
    keys = np.clip(pi, 0, None) * n + np.clip(pj, 0, None)
    pos = np.searchsorted(edge_keys, keys.ravel())
    pos = np.minimum(pos, max(len(edge_keys) - 1, 0))
    found = (edge_keys[pos] == keys.ravel()) if len(edge_keys) else \
        np.zeros(keys.size, bool)
    perm_adj = (found.reshape(keys.shape) & valid).astype(np.float32)

    P = len(perm_nodes)
    if p_cap and P < p_cap:
        pad = p_cap - P
        perm_nodes = np.concatenate(
            [perm_nodes, np.full((pad, s), -1, np.int32)])
        perm_adj = np.concatenate(
            [perm_adj, np.zeros((pad, s, s), np.float32)])
        perm_owner = np.concatenate(
            [perm_owner, np.full(pad, -1, np.int32)])
    return perm_nodes, perm_adj, perm_owner, degs


# --------------------------------------------------------------- device
def init_lrp(cfg: LRPConfig, generator=None, init: str = "scaled") -> Tree:
    """``init='randn'``: unit-variance contraction weights (the
    reference's); ``'scaled'`` (default, desco_tpu's) divides them by
    sqrt(S * S * h), which keeps the 4-layer forward trainable on graphs
    with hubs."""
    h, L = cfg.hid_dim, cfg.lrp_length
    g = generator
    scale = 1.0 if init == "randn" else 1.0 / np.sqrt(L * h)
    params = Tree({
        "atom": linear_params(cfg.input_dim, h, generator=g),
        "edge": linear_params(1, h, generator=g),
        "final": linear_params(h, cfg.num_tasks, generator=g),
    })
    layers = nn.ModuleList()
    for _ in range(cfg.num_layers):
        layer = Tree({"deg0": linear_params(1, 2 * h, generator=g),
                      "deg1": linear_params(2 * h, h, generator=g)})
        layer["w"] = nn.Parameter(torch.randn(h, h, L, generator=g) * scale)
        layer["b"] = nn.Parameter(torch.zeros(h))
        layers.append(layer)
    params["layers"] = layers
    return params


def _lrp_contract(w, e0, diag, perm_adj, s: int):
    """out[p, c] = sum_{a,b,h} nf[p,a,b,h] * W[h,c,a*s+b] without building
    nf: a diagonal term (node features) plus an off-diagonal one (the
    edge vector times the adjacency pattern)."""
    h_in = diag.shape[-1]
    wd = w[:, :, ::s + 1]                                # [h, c, s] diag
    dterm = torch.einsum("pah,hca->pc", diag, wd[:h_in])
    we = torch.einsum("h,hcl->lc", e0, w).reshape(s, s, -1)
    offmask = (1.0 - torch.eye(s, dtype=we.dtype, device=we.device))[
        :, :, None]
    eterm = torch.einsum("pab,abc->pc", perm_adj, we * offmask)
    return dterm + eterm


def _degree_factor(layer, degs):
    return layer["deg1"](torch.relu(layer["deg0"](degs[:, None])))


def apply_lrp(params, cfg: LRPConfig, x, perm_nodes, perm_adj, perm_owner,
              degs, n_nodes: int, node_mask=None):
    """One graph's LRP embedding -> [num_tasks]. x: [N, F]; perm_nodes:
    [P, S] (-1 pad); perm_adj: [P, S, S]; perm_owner: [P]; degs: [N]."""
    s = cfg.sub_len
    nfeat = params["atom"](x)                          # [N, h]
    e0 = params["edge"](x.new_ones(1))                 # [h]
    valid = (perm_nodes >= 0).to(nfeat.dtype)          # [P, S]
    safe_nodes = perm_nodes.long().clamp(min=0)
    pcount = segment_sum(torch.ones_like(perm_owner, dtype=nfeat.dtype),
                         perm_owner, n_nodes)
    for layer in params["layers"]:
        diag = nfeat[safe_nodes] * valid[..., None]
        out = torch.relu(_lrp_contract(layer["w"], e0, diag, perm_adj, s)
                         + layer["b"])                 # [P, h]
        pooled = segment_sum(out, perm_owner, n_nodes)
        pooled = pooled / pcount[:, None].clamp(min=1.0)
        nfeat = pooled * _degree_factor(layer, degs)
        if node_mask is not None:
            nfeat = nfeat * node_mask[:, None]
    if node_mask is not None:
        nfeat = nfeat * node_mask[:, None]
    return params["final"](nfeat.sum(0))


def apply_lrp_batch(params, cfg: LRPConfig, batch, perm_nodes, perm_adj,
                    perm_owner, degs):
    """Over a PackedGraphs whole-graph batch: the permutation arrays index
    batch-local node ids; returns [G, num_tasks] through per-graph
    pooling."""
    s = cfg.sub_len
    n_cap, g_cap = batch.n_cap, batch.g_cap
    nmask = batch.node_mask[:, None]
    nfeat = params["atom"](batch.x) * nmask
    e0 = params["edge"](nfeat.new_ones(1))
    valid = (perm_nodes >= 0).to(nfeat.dtype)
    safe_nodes = perm_nodes.long().clamp(min=0)
    owner = perm_owner.long().clamp(0, n_cap - 1)
    pvalid = (perm_owner >= 0).to(nfeat.dtype)
    pcount = segment_sum(pvalid, owner, n_cap)
    for layer in params["layers"]:
        diag = nfeat[safe_nodes] * valid[..., None]
        out = torch.relu(_lrp_contract(layer["w"], e0, diag, perm_adj, s)
                         + layer["b"]) * pvalid[:, None]
        pooled = segment_sum(out, owner, n_cap)
        pooled = pooled / pcount[:, None].clamp(min=1.0)
        nfeat = pooled * _degree_factor(layer, degs) * nmask
    return params["final"](segment_sum(nfeat, batch.node_graph, g_cap))
