"""Build GraphSamples from host graphs: SHMP edge typing (a copy of
``desco_tpu/batch/build.py``, order-3 typing only).

Every edge carries a type id and a single typed kernel handles all
relations. Type tables:

Neighborhood graphs (node types: 0=count, 1=canonical):
  with tconv (6 types, the reference's order-3 SHMP):
    0: count->count triangle     1: count->count tride
    2: count->canonical triangle 3: count->canonical tride
    4: canonical->count triangle 5: canonical->count tride
  without tconv (3 types):
    0: count->count  1: count->canonical  2: canonical->count

Query graphs (single node type):
  with tconv: 0: triangle, 1: tride;  without: 0: union

Gossip graphs (homogeneous): edge_type is the *direction bit* —
0 where src < dst (forward), 1 otherwise.

Order-4 (orbit) typing is not ported yet (ROADMAP.md, Queue 1 M14).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..graph.canonical import Neighborhood
from ..graph.container import Graph
from ..graph.triangles import triangle_edge_mask
from .packed import GraphSample

COUNT, CANONICAL = 0, 1

# dst node type of each edge type (for to_hetero-style per-dst-type bias
# accumulation)
NEIGH_TCONV_DST = (0, 0, 1, 1, 0, 0)
NEIGH_PLAIN_DST = (0, 1, 0)
QUERY_TCONV_DST = (0, 0)
QUERY_PLAIN_DST = (0,)


def _directed(edges: np.ndarray):
    """Undirected (m,2) -> directed src/dst arrays (2m,), plus the
    undirected edge index each directed edge came from."""
    if edges.shape[0] == 0:
        z = np.zeros(0, dtype=np.int32)
        return z, z, z
    src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int32)
    dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int32)
    eid = np.concatenate([np.arange(len(edges)), np.arange(len(edges))])
    return src, dst, eid.astype(np.int32)


def neighborhood_sample(
    nb: Neighborhood,
    use_tconv: bool = True,
    y: Optional[np.ndarray] = None,
    f_dim: int = 1,
    x: Optional[np.ndarray] = None,
    order: int = 3,
) -> GraphSample:
    if order != 3:
        raise NotImplementedError(
            f"order-{order} SHMP edge typing is not ported yet "
            f"(ROADMAP.md, Queue 1 M14)")
    g = nb.graph
    node_type = np.full(g.n_nodes, COUNT, dtype=np.int32)
    node_type[nb.canonical] = CANONICAL
    src, dst, eid = _directed(g.edges)
    s_can = node_type[src] == CANONICAL
    d_can = node_type[dst] == CANONICAL
    if use_tconv:
        tri = triangle_edge_mask(g)[eid] if len(eid) else np.zeros(0, bool)
        etype = np.where(
            s_can, np.where(tri, 4, 5),
            np.where(d_can, np.where(tri, 2, 3), np.where(tri, 0, 1)),
        ).astype(np.int32)
    else:
        etype = np.where(s_can, 2, np.where(d_can, 1, 0)).astype(np.int32)
    if x is None:
        x = np.zeros((g.n_nodes, f_dim), dtype=np.float32)
    return GraphSample(
        node_type=node_type, x=x.astype(np.float32),
        edge_src=src, edge_dst=dst, edge_type=etype, y=y,
    )


def query_sample(q: Graph, use_tconv: bool = True, f_dim: int = 1,
                 x: "Optional[np.ndarray]" = None) -> GraphSample:
    node_type = np.zeros(q.n_nodes, dtype=np.int32)
    src, dst, eid = _directed(q.edges)
    if use_tconv:
        tri = triangle_edge_mask(q)[eid] if len(eid) else np.zeros(0, bool)
        etype = np.where(tri, 0, 1).astype(np.int32)
    else:
        etype = np.zeros(len(src), dtype=np.int32)
    if x is None:
        x = (q.node_feat if q.node_feat is not None
             else np.zeros((q.n_nodes, f_dim)))
    return GraphSample(
        node_type=node_type, x=x.astype(np.float32),
        edge_src=src, edge_dst=dst, edge_type=etype,
    )


def gossip_sample(
    g: Graph,
    x_counts: np.ndarray,  # [k, Q] stage-1 predicted counts (node features)
    node_y: Optional[np.ndarray] = None,  # [k, Q] canonical count truth
) -> GraphSample:
    src, dst, _ = _directed(g.edges)
    etype = np.where(src < dst, 0, 1).astype(np.int32)
    return GraphSample(
        node_type=np.zeros(g.n_nodes, dtype=np.int32),
        x=x_counts.astype(np.float32),
        edge_src=src, edge_dst=dst, edge_type=etype,
        node_y=node_y,
    )
