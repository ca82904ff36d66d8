"""GraphSAGE in DeSCo's SHMP towers, per layer l over typed edges:

    m_i = sum_t (sum over type-t edges j -> i of h_j) @ W[l, t]
          + sum over t with d(t) = type(i) of b[l, t]
    h_i = relu([m_i, h_i] @ U[l, type(i)] + c[l, type(i)])

The program sums and transforms the target tower's typed messages in
one fused kernel (K2, its backward K3); the query tower's run through
the gather-fused K1 and its backward."""

from __future__ import annotations

import torch

from ..lib import flops as fl
from ..lib.weights import linear
from ..reference.model import mm, per_type, type_sum


def leaves(prefix, h, L, n_node_types, n_edge_types):
    return linear(f"{prefix}/upd", 2 * h, h, L, n_node_types)


def message(w, prefix, layer, t, h, src, dst, n):
    return mm(type_sum(h[src], dst, n), w[f"{prefix}/conv/0"][layer, t])


def update(w, prefix, layer, msg, h, ntype):
    return per_type(torch.cat([msg, h], dim=1),
                    w[f"{prefix}/upd/0"][layer],
                    w[f"{prefix}/upd/1"][layer], ntype)


def layer_flops(s, h, n_types):
    # the sum, then one product a (destination, type) run; the update
    return s["e"] * h + 2.0 * s["runs"] * h * h + 2.0 * s["n"] * 2 * h * h


def layer_least_s(s, h, n_types, fused, pk):
    n, e, runs = s["n"], s["e"], s["runs"]
    seg = n * n_types
    if fused:
        # K2: x and W in, the sources and run offsets, the f32 output out
        fwd = ((n * h + n_types * h * h) * 4 + e * 4 + (seg + 1) * 4
               + n * h * 4)
        # K3: g, x and W in, the streams, dx and dW out
        bwd = ((2 * n * h + n_types * h * h) * 4 + e * 4 + (seg + 1) * 4
               + (n * h + n_types * h * h) * 4)
        return (fl.least_s(fwd, e * h, 3 * 2.0 * runs * h * h, pk)
                + fl.least_s(bwd, e * h, 2 * 3 * 2.0 * runs * h * h, pk))
    # gather-fused K1: the rows it reads, the stream, [N*T, H] out; back
    fwd = n * h * 4 + e * 4 + (seg + 1) * 4 + seg * h * 4
    bwd = seg * h * 4 + e * 4 + (n + 1) * 4 + n * h * 4
    return fl.least_s(fwd, e * h, 0.0, pk) + fl.least_s(bwd, e * h, 0.0, pk)
