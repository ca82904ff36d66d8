"""Operations and bytes of the model's work, counted from the live shapes
of a batch (padding excluded), whatever implements it.

Model FLOPs count a multiply-add as two, over the equations of
``reference/model.py``: what the model needs, not what a kernel does (a
per-type linear counts each node under its own type only; the anchor MLP
counts the canonical node of each graph only). A training step counts
three forwards (the backward's two products per forward product).

The least time of a kernel call follows the bound arithmetic of the
port's smoke run: the larger of its bytes over the memory rate (each
input read once, each output written once), its f32 operations over the
f32 rate, and its tensor-core operations over their rate (split TF32,
three passes for f32 operands).
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict

import numpy as np

from .. import convs

_PEAKS = os.path.join(os.path.dirname(__file__), "peaks.json")


def peaks() -> dict:
    with open(_PEAKS) as f:
        return json.load(f)


def batch_shape(node_mask, graph_mask, edge_dst, edge_type,
                n_types: int) -> Dict[str, int]:
    """Live nodes ``n``, graphs ``g``, directed edges ``e`` and the
    (destination, type) runs ``runs`` of one packed batch (host arrays;
    padding edges carry a type past the model's)."""
    live = np.asarray(edge_type) < n_types
    keys = (np.asarray(edge_dst)[live].astype(np.int64) * n_types
            + np.asarray(edge_type)[live])
    return {"n": int(np.asarray(node_mask).sum()),
            "g": int(np.asarray(graph_mask).sum()),
            "e": int(live.sum()), "runs": int(np.unique(keys).size)}


def tower_flops(s: Dict[str, int], cfg: dict, n_types: int) -> float:
    """One SHMP tower's forward over a batch of shape ``s``."""
    h, L, f = (cfg["neigh_hidden_dim"], cfg["neigh_layer_num"],
               cfg["neigh_input_dim"])
    p = h * (L + 1)
    n, g = s["n"], s["g"]
    out = 2.0 * n * f * h  # pre
    layer = convs.load(cfg["conv_type"]).layer_flops(s, h, n_types)
    out += L * layer
    out += n * p                                # pooling
    out += 2.0 * g * p * p                      # anchor, canonical nodes
    out += 2.0 * g * (p * h + h * h + h * 256 + 256 * h)
    return out


def head_flops(g: int, q: int, h: int) -> float:
    return 2.0 * (g + q) * h * 4 * h + g * q * 4 * h + 2.0 * g * q * 4 * h


def train_step_flops(s: Dict[str, int], cfg: dict, n_queries: int) -> float:
    """A neighborhood train step: both towers, the count head, three
    forwards' worth (forward and backward)."""
    q = query_shape()
    return 3.0 * (tower_flops(s, cfg, 6) + tower_flops(q, cfg, 2)
                  + head_flops(s["g"], n_queries, cfg["neigh_hidden_dim"]))


def gossip_flops(s: Dict[str, int], cfg: dict, q: int) -> float:
    """The gossip forward over graphs of shape ``s``, all ``q`` queries."""
    h, emb, L = (cfg["gossip_hidden_dim"], cfg["neigh_hidden_dim"],
                 cfg["gossip_layer_num"])
    n, e = s["n"], s["e"]
    d0 = h + emb
    per = 2.0 * n * h
    d = d0
    for _ in range(L):
        per += 2.0 * e * d + 2.0 * n * d * h + 2.0 * n * (h + d) * h
        d = h
    post_in = h * L + d0
    per += 2.0 * n * (post_in * h + h * h + h * 256 + 256)
    return per * q


@functools.lru_cache(maxsize=None)
def query_shape() -> Dict[str, int]:
    """The query set's batch (29 graphs, two edge types)."""
    from ..reference.graphs import _typed_sample
    from ..reference.queries import QUERIES

    n = e = runs = 0
    for _, k, edges in QUERIES:
        _, src, dst, et = _typed_sample(k, np.asarray(edges, np.int64), -1)
        n += k
        e += len(src)
        runs += np.unique(dst * 2 + et).size
    return {"n": n, "g": len(QUERIES), "e": e, "runs": runs}


def least_s(bytes_moved: float, ops: float, tensor_ops: float = 0.0,
            pk: dict = None) -> float:
    pk = pk or peaks()
    return max(bytes_moved / pk["hbm_bytes_per_s"],
               ops / pk["f32_flops_per_s"],
               tensor_ops / pk["tf32_flops_per_s"])


def aggregation_least_s(s: Dict[str, int], cfg: dict, n_types: int,
                        fused: bool, pk: dict) -> float:
    """Least time of one tower's message aggregation, forward and
    backward, over a batch of shape ``s``: per layer the configuration's
    layer's (``convs/<conv_type>.py``; ``fused``: the target tower, where
    the program may run a fused typed kernel), and the pooling's K1
    forward and K4 backward."""
    h, L = cfg["neigh_hidden_dim"], cfg["neigh_layer_num"]
    p = h * (L + 1)
    n, g = s["n"], s["g"]
    t = L * convs.load(cfg["conv_type"]).layer_least_s(s, h, n_types,
                                                        fused, pk)
    pool = n * p * 4 + (g + 1) * 4 + g * p * 4
    t += least_s(pool, n * p, 0.0, pk)       # K1, the pooling
    t += least_s(pool, 0.0, 0.0, pk)         # K4, its backward
    return t


def bounds_least_s(s: Dict[str, int], n_queries: int, tree_steps: int,
                   pk: dict) -> float:
    """Least time of one batch's bounds: the edge stream (src, dst as
    int32) and three node arrays read once, [G, Q] written once; the
    tree DP's adds and products, ``tree_steps`` passes over the stream
    (one per tree edge, rooting and distinct spanning tree)."""
    n, e, g = s["n"], s["e"], s["g"]
    moved = e * 8 + n * 12 + g * n_queries * 4
    return least_s(moved, tree_steps * (e + n), 0.0, pk)


def tree_steps() -> int:
    """Passes of the bounds' tree DP over the edge stream: per distinct
    spanning tree of the queries (trees equal edge for edge share their
    passes), one per rooting and tree edge."""
    from ..reference.model import _spanning_tree
    from ..reference.queries import QUERIES

    trees = {(k, tuple(_spanning_tree(k, edges))) for _, k, edges in QUERIES}
    return sum(k * (k - 1) for k, _ in trees)
