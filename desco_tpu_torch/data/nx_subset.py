"""The parts of networkx 3.6.1 that desco_tpu's dataset generators reach,
copied as plain Python, so the port draws the same graphs without
networkx.

desco_tpu's synthetic datasets (``data/synthetic.py``) and TU proxies
(``data/tu_proxy.py``) index into lists built from networkx's iteration
order and draw from ``random.Random(seed)`` as they walk it. To give the
same graphs, this module reproduces that order exactly, not only the
edge sets: ``Graph`` keeps networkx's dict-of-dicts adjacency and
insertion order, ``connected_components`` builds the same Python sets in
the same insertion order (CPython's iteration order over an int set
depends on that history), and each generator makes the same calls on
the same ``random.Random`` in the same order. An int seed becomes
``random.Random(seed)``, as networkx's ``@py_random_state`` makes it.

Copied from networkx 3.6.1:

- ``classes/graph.py``: the ``Graph`` methods below (adjacency only, no
  attribute dicts);
- ``generators/random_graphs.py``: ``gnp_random_graph``
  (= ``erdos_renyi_graph``) :122-183, ``gnm_random_graph`` :256-310,
  ``watts_strogatz_graph`` :388-465, ``connected_watts_strogatz_graph``
  :468-521, ``_random_subset`` :644-656, ``barabasi_albert_graph``
  :659-732, ``powerlaw_cluster_graph`` :1006-1096;
- ``generators/geometric.py``: ``random_geometric_graph`` :114-205 with
  the scipy path of ``_geometric_edges`` :89-111 (2-D, p = 2, default
  positions), for the halo scaling tool's ``rgg`` graphs;
- ``generators/classic.py``: ``empty_graph``, ``complete_graph``,
  ``star_graph``;
- ``algorithms/tree/coding.py``: ``from_prufer_sequence`` :318-413;
- ``algorithms/components/connected.py``: ``connected_components``
  :16-90, ``is_connected`` :152-208, ``_plain_bfs`` :267-282;
- ``convert_matrix.py``: the undirected 0/1 path of ``from_numpy_array``
  :1120-1314;
- ``relabel.py``: ``convert_node_labels_to_integers`` :226-285 (default
  ordering) and ``Graph.subgraph(nodes).copy()`` (``classes/graph.py``,
  ``classes/coreviews.py``' ``FilterAtlas`` order).

networkx is distributed under the 3-clause BSD license:

   Copyright (c) 2004-2025, NetworkX Developers
   Aric Hagberg <hagberg@lanl.gov>
   Dan Schult <dschult@colgate.edu>
   Pieter Swart <swart@lanl.gov>
   All rights reserved.

   Redistribution and use in source and binary forms, with or without
   modification, are permitted provided that the following conditions are
   met:

     * Redistributions of source code must retain the above copyright
       notice, this list of conditions and the following disclaimer.

     * Redistributions in binary form must reproduce the above
       copyright notice, this list of conditions and the following
       disclaimer in the documentation and/or other materials provided
       with the distribution.

     * Neither the name of the NetworkX Developers nor the names of its
       contributors may be used to endorse or promote products derived
       from this software without specific prior written permission.

   THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
   "AS IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
   LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR
   A PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT
   OWNER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL,
   SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT
   LIMITED TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE,
   DATA, OR PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY
   THEORY OF LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT
   (INCLUDING NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE
   OF THIS SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
"""

from __future__ import annotations

import itertools
import random
from collections import Counter
from itertools import chain


class NetworkXException(Exception):
    """networkx's base exception."""


class NetworkXError(NetworkXException):
    """networkx's error for invalid arguments or a failed generation."""


class Graph:
    """An undirected simple graph with networkx's ``Graph`` order: a dict
    from node to a dict of its neighbors, both in insertion order."""

    def __init__(self):
        self._adj: dict = {}

    # ---------------------------------------------------------- nodes
    def add_node(self, n) -> None:
        if n not in self._adj:
            self._adj[n] = {}

    def add_nodes_from(self, nodes) -> None:
        for n in nodes:
            self.add_node(n)

    def nodes(self) -> list:
        return list(self._adj)

    def __iter__(self):
        return iter(self._adj)

    def __len__(self) -> int:
        return len(self._adj)

    def number_of_nodes(self) -> int:
        return len(self._adj)

    def neighbors(self, n):
        return iter(self._adj[n])

    def degree(self, n) -> int:
        nbrs = self._adj[n]
        return len(nbrs) + (n in nbrs)

    def degrees(self):
        """(node, degree) in node order (networkx's ``G.degree()``)."""
        return [(n, len(nbrs) + (n in nbrs)) for n, nbrs in self._adj.items()]

    # ---------------------------------------------------------- edges
    def add_edge(self, u, v) -> None:
        adj = self._adj
        if u not in adj:
            adj[u] = {}
        if v not in adj:
            adj[v] = {}
        adj[u][v] = True
        adj[v][u] = True

    def add_edges_from(self, edges) -> None:
        for u, v in edges:
            self.add_edge(u, v)

    def remove_edge(self, u, v) -> None:
        try:
            del self._adj[u][v]
            if u != v:  # self-loop needs only one entry removed
                del self._adj[v][u]
        except KeyError as err:
            raise NetworkXError(
                f"The edge {u}-{v} is not in the graph") from err

    def has_edge(self, u, v) -> bool:
        try:
            return v in self._adj[u]
        except KeyError:
            return False

    def edges(self) -> list:
        """Each edge once, as networkx's ``EdgeView`` walks them: nodes in
        order, each node's neighbors in order, skipping nodes already
        passed."""
        out = []
        seen = {}
        for n, nbrs in self._adj.items():
            for nbr in nbrs:
                if nbr not in seen:
                    out.append((n, nbr))
            seen[n] = 1
        return out

    def number_of_edges(self) -> int:
        return sum(d for _, d in self.degrees()) // 2

    # ------------------------------------------------------ subgraphs
    def subgraph_copy(self, nodes) -> "Graph":
        """``G.subgraph(nodes).copy()``: the node filter is a set built
        from ``nodes`` in their order; the copy walks that set when it is
        less than half the graph, the graph's node order otherwise
        (``FilterAtlas.__iter__``), and each node's neighbors in the
        graph's order."""
        adj = self._adj
        keep = set(n for n in nodes if n in adj)
        if 2 * len(keep) < len(adj):
            order = [n for n in keep if n in adj]
        else:
            order = [n for n in adj if n in keep]
        h = Graph()
        h.add_nodes_from(order)
        h.add_edges_from((u, v) for u in order for v in adj[u] if v in keep)
        return h


# ------------------------------------------------------------ classic
def empty_graph(n) -> Graph:
    g = Graph()
    g.add_nodes_from(range(n))
    return g


def complete_graph(n) -> Graph:
    g = empty_graph(n)
    if n > 1:
        g.add_edges_from(itertools.combinations(range(n), 2))
    return g


def star_graph(n) -> Graph:
    """Hub 0 joined to 1..n (n + 1 nodes)."""
    nodes = list(range(n)) + [n]
    g = Graph()
    g.add_nodes_from(nodes)
    if len(nodes) > 1:
        hub, *spokes = nodes
        g.add_edges_from((hub, node) for node in spokes)
    return g


def _rng(seed) -> random.Random:
    """``@py_random_state``: an int seed becomes ``random.Random(seed)``;
    a ``random.Random`` passes through."""
    if isinstance(seed, random.Random):
        return seed
    if isinstance(seed, int):
        return random.Random(seed)
    raise ValueError(f"{seed!r} cannot seed a random.Random here")


# ------------------------------------------------------ random graphs
def gnp_random_graph(n, p, seed=None) -> Graph:
    seed = _rng(seed)
    if p >= 1:
        return complete_graph(n)
    g = empty_graph(n)
    if p <= 0:
        return g
    for e in itertools.combinations(range(n), 2):
        if seed.random() < p:
            g.add_edge(*e)
    return g


erdos_renyi_graph = gnp_random_graph


def gnm_random_graph(n, m, seed=None) -> Graph:
    seed = _rng(seed)
    if n == 1:
        return empty_graph(n)
    max_edges = n * (n - 1) / 2.0
    if m >= max_edges:
        return complete_graph(n)
    g = empty_graph(n)
    nlist = list(g)
    edge_count = 0
    while edge_count < m:
        u = seed.choice(nlist)
        v = seed.choice(nlist)
        if u == v or g.has_edge(u, v):
            continue
        g.add_edge(u, v)
        edge_count = edge_count + 1
    return g


def watts_strogatz_graph(n, k, p, seed=None) -> Graph:
    seed = _rng(seed)
    if k > n:
        raise NetworkXError("k>n, choose smaller k or larger n")
    if k == n:
        return complete_graph(n)
    g = empty_graph(n)
    nodes = list(range(n))
    # connect each node to k/2 neighbors
    for j in range(1, k // 2 + 1):
        targets = nodes[j:] + nodes[0:j]
        g.add_edges_from(zip(nodes, targets))
    # rewire edges from each node, neighbors by distance, nodes in order
    for j in range(1, k // 2 + 1):
        targets = nodes[j:] + nodes[0:j]
        for u, v in zip(nodes, targets):
            if seed.random() < p:
                w = seed.choice(nodes)
                # no self-loops or multiple edges
                while w == u or g.has_edge(u, w):
                    w = seed.choice(nodes)
                    if g.degree(u) >= n - 1:
                        break  # skip this rewiring
                else:
                    g.remove_edge(u, v)
                    g.add_edge(u, w)
    return g


def connected_watts_strogatz_graph(n, k, p, tries=100, seed=None) -> Graph:
    seed = _rng(seed)
    for _ in range(tries):
        g = watts_strogatz_graph(n, k, p, seed)
        if is_connected(g):
            return g
    raise NetworkXError("Maximum number of tries exceeded")


def _random_subset(seq, m, rng) -> set:
    targets = set()
    while len(targets) < m:
        x = rng.choice(seq)
        targets.add(x)
    return targets


def barabasi_albert_graph(n, m, seed=None) -> Graph:
    seed = _rng(seed)
    if m < 1 or m >= n:
        raise NetworkXError(
            f"Barabási–Albert network must have m >= 1 and m < n, m = {m}, "
            f"n = {n}")
    g = star_graph(m)
    repeated_nodes = [v for v, d in g.degrees() for _ in range(d)]
    source = len(g)
    while source < n:
        targets = _random_subset(repeated_nodes, m, seed)
        g.add_edges_from(zip([source] * m, targets))
        repeated_nodes.extend(targets)
        repeated_nodes.extend([source] * m)
        source += 1
    return g


def powerlaw_cluster_graph(n, m, p, seed=None) -> Graph:
    seed = _rng(seed)
    if m < 1 or n < m:
        raise NetworkXError(
            f"NetworkXError must have m>1 and m<n, m={m},n={n}")
    if p > 1 or p < 0:
        raise NetworkXError(f"NetworkXError p must be in [0,1], p={p}")
    g = empty_graph(m)
    repeated_nodes = list(g)
    source = m
    while source < n:
        possible_targets = _random_subset(repeated_nodes, m, seed)
        # one preferential attachment for the new node
        target = possible_targets.pop()
        g.add_edge(source, target)
        repeated_nodes.append(target)
        count = 1
        while count < m:
            if seed.random() < p:  # clustering step: add a triangle
                neighborhood = [
                    nbr for nbr in g.neighbors(target)
                    if not g.has_edge(source, nbr) and nbr != source]
                if neighborhood:
                    nbr = seed.choice(neighborhood)
                    g.add_edge(source, nbr)
                    repeated_nodes.append(nbr)
                    count = count + 1
                    continue
            # preferential attachment when the triangle step fails
            target = possible_targets.pop()
            g.add_edge(source, target)
            repeated_nodes.append(target)
            count = count + 1
        repeated_nodes.extend([source] * m)
        source += 1
    return g


# -------------------------------------------------------------- trees
def from_prufer_sequence(sequence) -> Graph:
    n = len(sequence) + 2
    # remaining degree (plus one) of each node
    degree = Counter(chain(sequence, range(n)))
    t = empty_graph(n)
    not_orphaned = set()
    index = u = next(k for k in range(n) if degree[k] == 1)
    for v in sequence:
        if v < 0 or v > n - 1:
            raise NetworkXError(
                f"Invalid Prufer sequence: Values must be between 0 and "
                f"{n - 1}, got {v}")
        t.add_edge(u, v)
        not_orphaned.add(u)
        degree[v] -= 1
        if v < index and degree[v] == 1:
            u = v
        else:
            index = u = next(k for k in range(index + 1, n)
                             if degree[k] == 1)
    # exactly two orphaned nodes remain; join them
    orphans = set(t) - not_orphaned
    u, v = orphans
    t.add_edge(u, v)
    return t


# --------------------------------------------------------- components
def _plain_bfs(g: Graph, n: int, source) -> set:
    adj = g._adj
    seen = {source}
    nextlevel = [source]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
            if len(seen) == n:
                return seen
    return seen


def connected_components(g: Graph):
    """The node set of each component, in networkx's order (a generator,
    as networkx's is)."""
    seen = set()
    n = len(g)
    for v in g:
        if v not in seen:
            c = _plain_bfs(g, n - len(seen), v)
            seen.update(c)
            yield c


def is_connected(g: Graph) -> bool:
    n = len(g)
    if n == 0:
        raise NetworkXException(
            "Connectivity is undefined for the null graph.")
    return len(next(connected_components(g))) == n


def random_geometric_graph(n, radius, seed=None) -> Graph:
    """n nodes at uniform positions in the unit square, node by node, x
    then y, from ``random.Random(seed)``; an edge between every pair at
    Euclidean distance <= ``radius``, found by scipy's KD-tree and added
    in sorted pair order."""
    from scipy.spatial import cKDTree

    seed = _rng(seed)
    g = empty_graph(n)
    pos = [[seed.random() for _ in range(2)] for _ in g]
    g.add_edges_from(sorted(cKDTree(pos).query_pairs(radius, 2)))
    return g


# ------------------------------------------------------------ convert
def from_numpy_array(a) -> Graph:
    """An undirected graph with an edge at each nonzero of the square
    array ``a`` (networkx's default path: no weights kept)."""
    if a.ndim != 2:
        raise NetworkXError(f"Input array must be 2D, not {a.ndim}")
    n, m = a.shape
    if n != m:
        raise NetworkXError(f"Adjacency matrix not square: nx,ny={a.shape}")
    g = Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from((int(e[0]), int(e[1])) for e in zip(*a.nonzero()))
    return g


def convert_node_labels_to_integers(g: Graph, first_label: int = 0) -> Graph:
    """Nodes renamed first_label.. in node order; edges added in
    ``edges()`` order (networkx's ``relabel_nodes`` copy)."""
    mapping = dict(zip(g.nodes(), range(first_label,
                                        g.number_of_nodes() + first_label)))
    h = Graph()
    h.add_nodes_from(mapping.get(n, n) for n in g)
    h.add_edges_from((mapping.get(u, u), mapping.get(v, v))
                     for u, v in g.edges())
    return h
