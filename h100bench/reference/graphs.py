"""Plain host and tensor code for DeSCo's decomposition, written from its
definition: the canonical neighborhood of node v is the depth-d ball
around v (walked through every node), restricted to the nodes of index
<= v, restricted to the connected component that holds v; neighborhoods
without an edge are dropped. An edge is a triangle edge where its ends
share a neighbor (A * (A @ A) > 0, DeSCo's ``ToTconvHetero``).

The balls and components are dense boolean matrix products over a
graph's adjacency; no code of the program is used.

Edge types of a neighborhood sample (node types 0 = count, 1 =
canonical): 0 count -> count triangle, 1 count -> count other,
2 count -> canonical triangle, 3 count -> canonical other,
4 canonical -> count triangle, 5 canonical -> count other. Query
samples: 0 triangle, 1 other.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .queries import QUERIES


def adjacency(n: int, edges: np.ndarray) -> np.ndarray:
    a = np.zeros((n, n), np.float32)
    if len(edges):
        a[edges[:, 0], edges[:, 1]] = 1.0
        a[edges[:, 1], edges[:, 0]] = 1.0
    return a


def components(n: int, edges: np.ndarray, depth: int,
               device) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(member [n, n] bool: row v marks v's canonical neighborhood,
    n_nodes [n], n_edges [n] undirected) of one graph."""
    a = torch.as_tensor(adjacency(n, edges), device=device)
    eye = torch.eye(n, device=device)
    reach = eye.clone()
    for _ in range(depth):
        reach = ((reach @ a + reach) > 0).float()
    keep = reach * torch.tril(torch.ones(n, n, device=device))
    comp = eye.clone()
    while True:
        grown = (((comp @ a) + comp) * keep > 0).float()
        if torch.equal(grown, comp):
            break
        comp = grown
    n_nodes = comp.sum(dim=1)
    n_edges = ((comp @ a) * comp).sum(dim=1) / 2
    return (comp.bool().cpu().numpy(), n_nodes.long().cpu().numpy(),
            n_edges.long().cpu().numpy())


@dataclasses.dataclass
class Decomposition:
    """The canonical neighborhoods of a list of graphs, in the order
    graph by graph, node by node, edgeless ones dropped."""

    graphs: List[Tuple[int, np.ndarray]]
    index: np.ndarray      # [K, 2] (graph, node)
    n_nodes: np.ndarray    # [K]
    n_edges: np.ndarray    # [K] undirected
    members: List[np.ndarray]  # per graph: [n, n] bool

    def nodes(self, i: int) -> np.ndarray:
        gid, v = self.index[i]
        return np.nonzero(self.members[gid][v])[0]


def decompose(graphs: Sequence[Tuple[int, np.ndarray]], depth: int,
              device) -> Decomposition:
    index, nn_, ne_, members = [], [], [], []
    for gid, (n, edges) in enumerate(graphs):
        comp, n_nodes, n_edges = components(n, edges, depth, device)
        members.append(comp)
        for v in range(n):
            if n_edges[v] > 0:
                index.append((gid, v))
                nn_.append(n_nodes[v])
                ne_.append(n_edges[v])
    return Decomposition(list(graphs), np.asarray(index, np.int64).reshape(
        -1, 2), np.asarray(nn_, np.int64), np.asarray(ne_, np.int64),
        members)


@dataclasses.dataclass
class Batch:
    """A disjoint union of typed graphs, no padding."""

    x: torch.Tensor        # [N, F]
    ntype: torch.Tensor    # [N] long
    graph: torch.Tensor    # [N] long
    n_graphs: int
    src: torch.Tensor      # [E] long, directed
    dst: torch.Tensor
    etype: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[0]


def _typed_sample(n: int, edges: np.ndarray, canonical: int):
    """(node types, src, dst, edge types) of one sample; ``canonical``
    -1 for a query graph."""
    a = adjacency(n, edges)
    tri = (a @ a) > 0
    src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int64)
    dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int64)
    is_tri = tri[src, dst]
    ntype = np.zeros(n, np.int64)
    if canonical < 0:
        return ntype, src, dst, np.where(is_tri, 0, 1)
    ntype[canonical] = 1
    s_can, d_can = ntype[src] == 1, ntype[dst] == 1
    et = np.where(s_can, np.where(is_tri, 4, 5),
                  np.where(d_can, np.where(is_tri, 2, 3),
                           np.where(is_tri, 0, 1)))
    return ntype, src, dst, et


def union(samples, device, f_dim: int = 1) -> Batch:
    """One Batch of (n, node types, src, dst, edge types) samples."""
    nt, gr, ss, dd, ee = [], [], [], [], []
    off = 0
    for g, (n, ntype, src, dst, et) in enumerate(samples):
        nt.append(ntype)
        gr.append(np.full(n, g, np.int64))
        ss.append(src + off)
        dd.append(dst + off)
        ee.append(et)
        off += n

    def t(parts):
        return torch.as_tensor(np.concatenate(parts).astype(np.int64),
                               device=device)

    return Batch(torch.zeros(off, f_dim, device=device), t(nt), t(gr),
                 len(samples), t(ss), t(dd), t(ee))


def neighborhood_batch(dec: Decomposition, rows: Sequence[int],
                       device) -> Batch:
    """The typed samples of neighborhoods ``rows`` of ``dec``, in that
    order, as one Batch."""
    samples = []
    for i in rows:
        gid, v = dec.index[i]
        n_g, edges = dec.graphs[gid]
        nodes = dec.nodes(i)
        local = np.full(n_g, -1, np.int64)
        local[nodes] = np.arange(len(nodes))
        e = edges[(local[edges[:, 0]] >= 0) & (local[edges[:, 1]] >= 0)]
        e = local[e]
        ntype, src, dst, et = _typed_sample(len(nodes), e,
                                            int(local[v]))
        samples.append((len(nodes), ntype, src, dst, et))
    return union(samples, device)


def query_batch(device) -> Batch:
    samples = []
    for _, n, edges in QUERIES:
        e = np.asarray(edges, np.int64)
        samples.append((n, *_typed_sample(n, e, -1)))
    return union(samples, device)


def graph_batch(graphs: Sequence[Tuple[int, np.ndarray]], device) -> Batch:
    """The whole graphs as one Batch; edge type is the direction bit, 0
    where src < dst (the gossip stage's input)."""
    samples = []
    for n, edges in graphs:
        e = np.asarray(edges, np.int64).reshape(-1, 2)
        src = np.concatenate([e[:, 0], e[:, 1]])
        dst = np.concatenate([e[:, 1], e[:, 0]])
        samples.append((n, np.zeros(n, np.int64), src, dst,
                        (src > dst).astype(np.int64)))
    return union(samples, device)


def greedy_batches(n_nodes: np.ndarray, n_edges: np.ndarray, n_cap: int,
                   e_cap: int, g_cap: int) -> List[Tuple[int, int]]:
    """[lo, hi) ranges of consecutive samples cut into batches of at most
    ``n_cap - 1`` nodes (a slot stays for padding), ``e_cap`` directed
    edges and ``g_cap`` samples, a new batch where the next sample would
    not fit."""
    out, start, nu, eu = [], 0, 0, 0
    for i, (n, e) in enumerate(zip(n_nodes, 2 * n_edges)):
        if i > start and (nu + n > n_cap - 1 or eu + e > e_cap
                          or i - start >= g_cap):
            out.append((start, i))
            start, nu, eu = i, 0, 0
        nu += n
        eu += e
    if start < len(n_nodes):
        out.append((start, len(n_nodes)))
    return out
