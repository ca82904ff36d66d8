"""GAT (Velickovic et al., arXiv:1710.10903) in DeSCo's SHMP towers: one
head, PyG's GATConv per edge type with self loops. Per layer l and type
t:

    z_t = h @ W[l, t]; the logit of an edge j -> i is
    leaky_relu(a_src[l, t] . z_t[j] + a_dst[l, t] . z_t[i], 0.2),
    of the self loop leaky_relu((a_src + a_dst)[l, t] . z_t[i]);
    m_i = sum_t softmax-weighted sum of z_t over {self} and the type-t
    edges into i, plus the bias sum as SAGE's; h_i = relu(m_i)

The program sums the numerators and denominators in one K1 pair a layer
and takes their backward in one K4 pair."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..lib import flops as fl
from ..reference.model import mm, type_sum


def leaves(prefix, h, L, n_node_types, n_edge_types):
    # attention vectors U(-k, k), k = sqrt(3 / H): unit variance over H
    k = math.sqrt(3.0 / h)
    return [(f"{prefix}/att/0", (L, n_edge_types, h), k),
            (f"{prefix}/att/1", (L, n_edge_types, h), k)]


def message(w, prefix, layer, t, h, src, dst, n):
    z = mm(h, w[f"{prefix}/conv/0"][layer, t])
    a_src = w[f"{prefix}/att/0"][layer, t]
    a_dst = w[f"{prefix}/att/1"][layer, t]
    s_src, s_dst = mm(z, a_src[:, None])[:, 0], mm(z, a_dst[:, None])[:, 0]
    logit = F.leaky_relu(s_src[src] + s_dst[dst], 0.2)
    self_logit = F.leaky_relu(s_src + s_dst, 0.2)
    top = self_logit.detach().clone()
    top = top.scatter_reduce(0, dst, logit.detach(), "amax",
                             include_self=True)
    w_e = torch.exp(logit - top[dst])
    w_self = torch.exp(self_logit - top)
    num = w_self[:, None] * z + type_sum(w_e[:, None] * z[src], dst, n)
    den = w_self + type_sum(w_e, dst, n)
    return num / den[:, None]


def update(w, prefix, layer, msg, h, ntype):
    return msg


def layer_flops(s, h, n_types):
    n, e = s["n"], s["e"]
    # every node's row under every type (the self loop): z_t, the two
    # logit dots, the weighted sums and the division
    return (2.0 * n * n_types * h * h + 4.0 * n * n_types * h
            + e * (2 * h + 4) + n * n_types * (2 * h + 4)
            + n * n_types * h)


def layer_least_s(s, h, n_types, fused, pk):
    n, e = s["n"], s["e"]
    seg = n * n_types
    # the pair: num [E, H] and den [E] summed into N*T segments; back
    fwd = e * (h + 1) * 4 + e * 4 + (seg + 1) * 4 + seg * (h + 1) * 4
    bwd = seg * (h + 1) * 4 + e * 4 + e * (h + 1) * 4
    return (fl.least_s(fwd, e * (h + 1), 0.0, pk)
            + fl.least_s(bwd, 0.0, 0.0, pk))
