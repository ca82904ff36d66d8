"""Structural proxies for the TU benchmark suite — a copy of
``desco_tpu/data/tu_proxy.py`` whose networkx calls run through
``nx_subset`` (networkx 3.6.1's code paths copied as plain Python), so
both packages make the same graphs from the same seed.

desco_tpu's headline table evaluates on five TU datasets (MUTAG, COX2,
ENZYMES, IMDB-BINARY, MSRC-21) whose raw files a machine without network
access cannot fetch. These generators make synthetic families whose
published summary statistics (graph count, size range, mean nodes and
edges, structural character) match each TU dataset. They are not the
real benchmarks, and results on them are labeled as proxies.

Families:

* ``ChemProxy`` (MUTAG-like, 188 graphs): fused 5/6-rings + pendant
  chains, valence cap 4. Target stats n~17.9, m~19.8, n in [10, 28].
* ``ChemBigProxy`` (COX2-like, 467 graphs): the same chemistry at COX2
  scale (n~41.2, m~43.5).
* ``GeoProxy`` (ENZYMES-like, 600 graphs): random geometric graphs
  (n~32.6, m~62.1).
* ``EgoProxy`` (IMDB-BINARY-like, 1000 graphs): overlapping actor
  cliques, one per movie over a shared cast (n~19.8, m~96.5).
* ``SuperpixelProxy`` (MSRC-21-like, 563 graphs): Delaunay triangulation
  of jittered points, thinned to the published density (n~77.5,
  m~198.3).

All generators are deterministic in ``seed`` and disk-cached in the TU
raw format by the writer ``Syn_N`` uses (synthetic.py).
"""


from __future__ import annotations

import os
from typing import List

import numpy as np

from ..graph.container import Graph
from . import nx_subset as nxs
from .synthetic import (
    random_relabel,
    raw_paths,
    read_edge_list_dataset,
    write_edge_list_dataset,
)


def _lognormal_size(rng: np.random.Generator, mean: float,
                    lo: int, hi: int, sigma: float = 0.45) -> int:
    """Right-skewed graph-size sampler whose mean tracks ``mean``
    (TU size histograms are lognormal-ish: many small, a long tail)."""
    mu = np.log(mean) - 0.5 * sigma * sigma
    return int(np.clip(round(rng.lognormal(mu, sigma)), lo, hi))


# --------------------------------------------------------------------- #
# chemistry-like: fused rings + pendants, valence-capped
# --------------------------------------------------------------------- #

def _gen_molecule(rng: np.random.Generator, target_n: int) -> nxs.Graph:
    """One molecule-like graph: a fused/bridged ring system grown to
    ``target_n`` atoms with degree-capped pendant chains."""
    g = nxs.Graph()

    def ring_size() -> int:
        return 6 if rng.random() < 0.7 else 5

    # first ring
    k = ring_size()
    g.add_edges_from((i, (i + 1) % k) for i in range(k))
    n_rings = 1 + int(rng.integers(0, max(1, target_n // 7)))
    for _ in range(n_rings - 1):
        if g.number_of_nodes() + 4 > target_n:
            break
        k = ring_size()
        if rng.random() < 0.6:
            # fuse: share an existing edge whose endpoints can take one
            # more bond each (aromatic fusion, naphthalene-style)
            cands = [(u, v) for u, v in g.edges()
                     if g.degree(u) <= 2 and g.degree(v) <= 2]
            if not cands:
                cands = list(g.edges())
            u, v = cands[int(rng.integers(len(cands)))]
            new = list(range(g.number_of_nodes(),
                             g.number_of_nodes() + k - 2))
            path = [u] + new + [v]
            g.add_edges_from(zip(path, path[1:]))
        else:
            # bridge: a fresh ring joined by a single bond (biphenyl-style)
            anchors = [x for x in g.nodes() if g.degree(x) < 3]
            a = (anchors[int(rng.integers(len(anchors)))] if anchors
                 else int(rng.integers(g.number_of_nodes())))
            base = g.number_of_nodes()
            ring = [base + i for i in range(k)]
            g.add_edges_from(
                (ring[i], ring[(i + 1) % k]) for i in range(k))
            g.add_edge(a, ring[0])
    # pendant chains (substituents) until the size target is met
    while g.number_of_nodes() < target_n:
        anchors = [x for x in g.nodes() if g.degree(x) < 4]
        if not anchors:
            break
        a = anchors[int(rng.integers(len(anchors)))]
        chain = 1 + int(rng.integers(0, 2))
        for _ in range(min(chain, target_n - g.number_of_nodes())):
            b = g.number_of_nodes()
            g.add_edge(a, b)
            a = b
    return g


def generate_chem_proxy(
    num_graphs: int, seed: int = 0,
    min_size: int = 10, max_size: int = 28, mean_size: float = 17.9,
) -> List[Graph]:
    """MUTAG-statistics fused-ring molecules (COX2 scale via params)."""
    rng = np.random.default_rng(seed)
    graphs: List[Graph] = []
    # triangular-ish distribution centered on the published mean
    lo, hi = min_size, max_size
    mode = min(max(mean_size, lo), hi)
    for _ in range(num_graphs):
        n = int(round(rng.triangular(lo, mode, hi)))
        g = _gen_molecule(rng, n)
        graphs.append(random_relabel(g, rng))
    return graphs


# --------------------------------------------------------------------- #
# geometric: protein-contact-like random geometric graphs
# --------------------------------------------------------------------- #

def generate_geo_proxy(
    num_graphs: int, seed: int = 0,
    min_size: int = 12, max_size: int = 96, mean_size: float = 32.6,
    avg_degree: float = 4.3,
) -> List[Graph]:
    """ENZYMES-statistics random geometric graphs (2D contact radius
    tuned per graph to the published average degree), forced connected
    by linking each non-giant component to its nearest giant node."""
    rng = np.random.default_rng(seed)
    graphs: List[Graph] = []
    for _ in range(num_graphs):
        n = _lognormal_size(rng, mean_size, min_size, max_size)
        pts = rng.random((n, 2))
        # expected degree of an RGG away from the border ~ n*pi*r^2
        r = float(np.sqrt(avg_degree / (np.pi * max(n - 1, 1))))
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        adj = (d2 <= r * r) & ~np.eye(n, dtype=bool)
        g = nxs.from_numpy_array(adj.astype(np.int8))
        comps = sorted(nxs.connected_components(g), key=len, reverse=True)
        giant = list(comps[0])
        for comp in comps[1:]:
            comp = list(comp)
            sub = d2[np.ix_(comp, giant)]
            i, j = np.unravel_index(int(np.argmin(sub)), sub.shape)
            g.add_edge(comp[i], giant[j])
            giant.extend(comp)
        graphs.append(random_relabel(g, rng))
    return graphs


# --------------------------------------------------------------------- #
# ego-nets: unions of overlapping cliques (actor collaboration)
# --------------------------------------------------------------------- #

def generate_ego_proxy(
    num_graphs: int, seed: int = 0,
    min_size: int = 12, max_size: int = 60, mean_size: float = 19.8,
) -> List[Graph]:
    """IMDB-BINARY-statistics ego networks: each graph is an actor's
    ego-net — one clique per movie over a shared, overlapping cast, plus
    the ego connected to everyone. Published stats n~19.8, m~96.5."""
    rng = np.random.default_rng(seed)
    graphs: List[Graph] = []
    for _ in range(num_graphs):
        n = _lognormal_size(rng, mean_size, min_size, max_size)
        g = nxs.Graph()
        g.add_nodes_from(range(n))
        # node 0 is the ego; co-stars are 1..n-1
        others = np.arange(1, n)
        n_movies = 1 + int(rng.integers(1, 5))
        for _ in range(n_movies):
            cast = rng.choice(
                others, size=min(len(others),
                                 3 + int(rng.integers(2, 10))),
                replace=False)
            members = np.concatenate([[0], cast])
            for i in range(len(members)):
                for j in range(i + 1, len(members)):
                    g.add_edge(int(members[i]), int(members[j]))
        # every co-star appeared with the ego in at least one movie
        for v in others:
            g.add_edge(0, int(v))
        graphs.append(random_relabel(g, rng))
    return graphs


# --------------------------------------------------------------------- #
# superpixels: thinned Delaunay meshes (region adjacency)
# --------------------------------------------------------------------- #

def generate_superpixel_proxy(
    num_graphs: int, seed: int = 0,
    min_size: int = 40, max_size: int = 140, mean_size: float = 77.5,
    target_degree: float = 5.1,
) -> List[Graph]:
    """MSRC-21-statistics planar meshes: Delaunay triangulation of
    jittered grid points, edges thinned (longest first) to the published
    average degree while keeping the graph connected."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    graphs: List[Graph] = []
    for _ in range(num_graphs):
        n = int(round(rng.triangular(min_size, mean_size, max_size)))
        side = int(np.ceil(np.sqrt(n)))
        xs, ys = np.meshgrid(np.arange(side), np.arange(side))
        pts = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float64)
        pts = pts[rng.permutation(len(pts))[:n]]
        pts += rng.normal(0, 0.25, pts.shape)
        tri = Delaunay(pts)
        g = nxs.Graph()
        g.add_nodes_from(range(n))
        for simplex in tri.simplices:
            a, b, c = (int(x) for x in simplex)
            g.add_edge(a, b)
            g.add_edge(b, c)
            g.add_edge(a, c)
        target_m = int(round(target_degree * n / 2))
        # drop longest edges first; skip bridges to stay connected
        lengths = sorted(
            ((float(((pts[u] - pts[v]) ** 2).sum()), u, v)
             for u, v in g.edges()),
            reverse=True)
        for _, u, v in lengths:
            if g.number_of_edges() <= target_m:
                break
            g.remove_edge(u, v)
            if not nxs.is_connected(g):
                g.add_edge(u, v)
        graphs.append(random_relabel(g, rng))
    return graphs


# registry: proxy name -> (generator, num_graphs kwargs)
TU_PROXY_RECIPES = {
    # name: (fn, default count, kwargs)
    "ChemProxy": (generate_chem_proxy, 188, {}),
    "ChemBigProxy": (generate_chem_proxy, 467, dict(
        min_size=26, max_size=56, mean_size=41.2)),
    "GeoProxy": (generate_geo_proxy, 600, {}),
    "EgoProxy": (generate_ego_proxy, 1000, {}),
    "SuperpixelProxy": (generate_superpixel_proxy, 563, {}),
}


def load_or_generate_proxy(name: str, root: str, seed: int = 0
                           ) -> List[Graph]:
    """Disk-cached proxy dataset in the shared Syn raw format. As in
    desco_tpu, the generating run returns the graphs in memory (generator
    edge order) and later runs the read-back (sorted edges): the edge
    sets are the same."""
    fn, count, kwargs = TU_PROXY_RECIPES[name]
    a_path, ind_path = raw_paths(root)
    if os.path.exists(a_path) and os.path.exists(ind_path):
        return read_edge_list_dataset(a_path, ind_path)
    graphs = fn(count, seed=seed, **kwargs)
    write_edge_list_dataset(graphs, root)
    return graphs
