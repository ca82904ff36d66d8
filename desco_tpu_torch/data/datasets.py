"""Dataset registry and loaders — the port of
``desco_tpu/data/datasets.py``, with its names and suffixes:

* ``<name>_train`` / ``_val`` / ``_test``: a fixed-seed shuffled 25/25/50
  split of the full dataset (``random.Random(0).shuffle``);
* ``<name>_max<N>``: the graphs with at most N nodes, applied after the
  split;
* ``<name>_decreaseByDegree`` / ``_increaseByDegree`` / ``_random``:
  per-graph node relabeling before anything else (node order is
  load-bearing for the canonical partition);
* ``Syn_<N>`` and ``syn_<N>``: desco_tpu's synthetic datasets, the same
  graphs (``data/synthetic.py``), cached under ``<root>/<name>/raw``;
* the TU proxies (``data/tu_proxy.py``);
* TU-format files (MUTAG, COX2, ENZYMES, MSRC_21, IMDB-BINARY, ...),
  SNAP edge lists, Planetoid, ZINC and ogbn-arxiv, read from local files
  under ``<root>/<name>/raw``: nothing is fetched, and a missing file
  raises ``FileNotFoundError`` naming its path.

One name is the port's own: ``SynNp_<n>[_<seed>]``, n random connected
graphs from the port's numpy generator (``synthetic.random_connected_graphs``,
seed 0 unless given), which takes the suffixes too.
"""

from __future__ import annotations

import hashlib
import os
import random
import re
from typing import List, Optional, Tuple

import numpy as np

from ..graph.container import Graph, relabel_graph
from .synthetic import (
    load_or_generate_synthetic,
    random_connected_graphs,
    read_edge_list_dataset,
)
from .tu_proxy import TU_PROXY_RECIPES, load_or_generate_proxy

_SYN_NP = re.compile(r"SynNp_(\d+)(?:_(\d+))?")
# the fractions of the `_train` / `_val` split; `_test` takes the rest
TRAIN_SPLIT = 0.25
VAL_SPLIT = 0.25

# canonical-name table: registry name -> TU directory name
TU_NAMES = {
    "MUTAG": "MUTAG",
    "COX2": "COX2",
    "ENZYMES": "ENZYMES",
    "MSRC-21": "MSRC_21",
    "IMDB-BINARY": "IMDB-BINARY",
    "IMDB-MULTI": "IMDB-MULTI",
    "FIRSTMM-DB": "FIRSTMM_DB",
    "REDDIT-BINARY": "REDDIT-BINARY",
    "COLORS-3": "COLORS-3",
    "DD": "DD",
}


def load_tu_dataset(root: str, name: str,
                    with_labels: bool = False) -> List[Graph]:
    """Standard TU format reader: ``<root>/<name>/raw/<name>_A.txt``,
    ``_graph_indicator.txt``, optional ``_node_labels.txt``."""
    raw = os.path.join(root, name, "raw")
    a = os.path.join(raw, f"{name}_A.txt")
    ind = os.path.join(raw, f"{name}_graph_indicator.txt")
    if not os.path.exists(a):
        raise FileNotFoundError(
            f"TU dataset files not found under {raw}: nothing is "
            "fetched; place the standard TU files there "
            f"({name}_A.txt, {name}_graph_indicator.txt)."
        )
    graphs = read_edge_list_dataset(a, ind)
    lab = os.path.join(raw, f"{name}_node_labels.txt")
    if with_labels and os.path.exists(lab):
        labels = np.loadtxt(lab, dtype=np.int64).reshape(-1)
        off = 0
        n_lab = int(labels.max()) + 1
        for g in graphs:
            onehot = np.eye(n_lab, dtype=np.float32)[labels[off:off + g.n_nodes]]
            g.node_feat = onehot
            off += g.n_nodes
    return graphs


def load_snap_edgelist(root: str, name: str,
                       filename: str = "edges.txt") -> List[Graph]:
    """Single-graph SNAP-style edge-list datasets (P2P = p2p-Gnutella04,
    Astro = ca-AstroPh): nothing is fetched, so the file must exist at
    ``<root>/<name>/raw/<filename>``. Node ids are compacted to 0..n-1
    preserving order; the graph is undirected and deduplicated."""
    path = os.path.join(root, name, "raw", filename)
    if not os.path.exists(path):
        sources = {"P2P": "p2p-Gnutella04 (snap.stanford.edu)",
                   "Astro": "ca-AstroPh (snap.stanford.edu)"}
        raise FileNotFoundError(
            f"edge list not found at {path}: nothing is fetched; "
            f"export {sources.get(name, name)} and place the edge list "
            f"there.")
    edges = np.loadtxt(path, dtype=np.int64, comments="#").reshape(-1, 2)
    ids = np.unique(edges)
    remap = {int(v): i for i, v in enumerate(ids)}
    e = np.array([(remap[int(u)], remap[int(v)]) for u, v in edges
                  if u != v], np.int64).reshape(-1, 2)
    e = (np.unique(np.sort(e, axis=1), axis=0) if len(e)
         else np.zeros((0, 2), np.int64))
    return [Graph(len(ids), e.astype(np.int32))]


def load_planetoid(root: str, name: str) -> List[Graph]:
    """Planetoid citation graphs (Cora/CiteSeer) from the standard
    ``ind.<name>.{x,tx,allx,y,ty,ally,graph,test.index}`` raw files (the
    format PyG's Planetoid downloads). Returns
    ONE Graph with dense bag-of-words ``node_feat``; class labels are
    appended as the LAST feature column (integer id) so downstream tasks
    can recover them."""
    import pickle

    import scipy.sparse as sp

    raw = os.path.join(root, name, "raw")
    lower = name.lower()

    def rd(suffix):
        path = os.path.join(raw, f"ind.{lower}.{suffix}")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"Planetoid raw file missing: {path}. Nothing is fetched; "
                f"place the standard ind.{lower}.* files there.")
        with open(path, "rb") as f:
            return pickle.load(f, encoding="latin1")

    allx, tx = rd("allx"), rd("tx")
    ally, ty = np.asarray(rd("ally")), np.asarray(rd("ty"))
    graph = rd("graph")
    tindex_path = os.path.join(raw, f"ind.{lower}.test.index")
    test_idx = np.loadtxt(tindex_path, dtype=np.int64).reshape(-1)
    test_sorted = np.sort(test_idx)

    n_all = allx.shape[0]
    full_range = np.arange(test_sorted.min(), test_sorted.max() + 1)
    if len(full_range) > len(test_idx):
        # CiteSeer: isolated test nodes missing from test.index — extend
        # tx/ty with zero rows at the gaps
        tx_ext = sp.lil_matrix((len(full_range), tx.shape[1]),
                               dtype=np.float32)
        tx_ext[test_sorted - full_range.min()] = tx
        ty_ext = np.zeros((len(full_range), ty.shape[1]), ty.dtype)
        ty_ext[test_sorted - full_range.min()] = ty
        tx, ty = tx_ext.tocsr(), ty_ext
    feats = sp.vstack([allx, tx]).tolil()
    labels = np.vstack([ally, ty])
    # test rows arrive shuffled: permute them into test.index positions
    feats[test_idx] = feats[test_sorted]
    labels[test_idx] = labels[test_sorted]
    n = n_all + tx.shape[0]
    edges = []
    for u, nbrs in graph.items():
        for v in nbrs:
            if u != v and 0 <= u < n and 0 <= v < n:
                edges.append((min(u, v), max(u, v)))
    e = (np.unique(np.array(edges, np.int64), axis=0)
         if edges else np.zeros((0, 2), np.int64))
    x = np.asarray(feats.todense(), dtype=np.float32)
    y_col = labels.argmax(-1).astype(np.float32)[:, None]
    return [Graph(n, e.astype(np.int32),
                  np.concatenate([x, y_col], axis=1))]


def load_zinc(root: str) -> List[Graph]:
    """ZINC molecules from the standard benchmarking-gnns pickles
    (``{train,val,test}.pickle`` under ``<root>/ZINC/raw`` — the raw
    format PyG's ZINC dataset downloads). Node
    features are one-hot atom types (28 classes)."""
    raw = os.path.join(root, "ZINC", "raw")
    import pickle

    mols = []
    found = False
    for split in ("train", "val", "test"):
        path = os.path.join(raw, f"{split}.pickle")
        if os.path.exists(path):
            found = True
            with open(path, "rb") as f:
                mols.extend(pickle.load(f))
    if not found:
        raise FileNotFoundError(
            f"ZINC pickles not found under {raw}; nothing is fetched: "
            "place the standard train/val/test.pickle files there.")
    n_atom_types = 28
    eye = np.eye(n_atom_types, dtype=np.float32)
    graphs = []
    for m in mols:
        atom = np.asarray(m["atom_type"]).reshape(-1).astype(np.int64)
        bond = np.asarray(m["bond_type"])
        u, v = np.nonzero(bond)
        keep = u < v
        e = np.stack([u[keep], v[keep]], axis=1).astype(np.int32)
        graphs.append(Graph(len(atom), e, eye[np.clip(atom, 0,
                                                      n_atom_types - 1)]))
    return graphs


def load_ogb_arxiv(root: str) -> List[Graph]:
    """ogbn-arxiv from the standard OGB raw csv.gz files
    (``edge.csv.gz``, ``node-feat.csv.gz``, ``node-label.csv.gz`` under
    ``<root>/arXiv/raw``). One Graph; 128-dim
    features with the subject label appended as the last column."""
    import gzip

    raw = os.path.join(root, "arXiv", "raw")
    epath = os.path.join(raw, "edge.csv.gz")
    if not os.path.exists(epath):
        raise FileNotFoundError(
            f"OGB raw files not found under {raw}; nothing is fetched: "
            "place edge.csv.gz / node-feat.csv.gz / node-label.csv.gz "
            "there.")

    def rd_csv(name):
        with gzip.open(os.path.join(raw, name), "rt") as f:
            return np.loadtxt(f, delimiter=",", ndmin=2)

    edges = rd_csv("edge.csv.gz").astype(np.int64)
    feat = rd_csv("node-feat.csv.gz").astype(np.float32)
    label = rd_csv("node-label.csv.gz").astype(np.float32).reshape(-1, 1)
    n = feat.shape[0]
    e = edges[edges[:, 0] != edges[:, 1]]
    e = np.unique(np.sort(e, axis=1), axis=0)
    return [Graph(n, e.astype(np.int32),
                  np.concatenate([feat, label], axis=1))]


def _relabel_all(graphs: List[Graph], mode: str, seed: int = 0) -> List[Graph]:
    rng = np.random.default_rng(seed)
    out = []
    for g in graphs:
        deg = g.degrees()
        if mode == "decreasing_degree":
            order = np.argsort(-deg, kind="stable")
        elif mode == "increasing_degree":
            order = np.argsort(deg, kind="stable")
        elif mode == "random":
            order = rng.permutation(g.n_nodes)
        else:
            raise ValueError(mode)
        mapping = np.empty(g.n_nodes, dtype=np.int32)
        mapping[order] = np.arange(g.n_nodes, dtype=np.int32)
        out.append(relabel_graph(g, mapping))
    return out


def fingerprint(graphs: List[Graph]) -> str:
    """The first 16 hex digits of a sha256 over the graphs in order: per
    graph its node count as one little-endian int64, then its edges as an
    int64 [E, 2] array, each row sorted (u < v), rows sorted by (u, v).
    Equal for two lists with the same graphs whatever their edge order."""
    h = hashlib.sha256()
    for g in graphs:
        h.update(np.array(g.n_nodes, "<i8").tobytes())
        e = np.sort(np.asarray(g.edges, np.int64).reshape(-1, 2), axis=1)
        e = e[np.lexsort((e[:, 1], e[:, 0]))]
        h.update(e.astype("<i8").tobytes())
    return h.hexdigest()[:16]


def load_data(
    dataset_name: str,
    root_folder: str = "data",
    with_labels: bool = False,
) -> List[Graph]:
    """The graphs of dataset ``dataset_name``, with desco_tpu's suffix
    conventions (module docstring); files are read, or generated datasets
    cached, under ``root_folder``."""
    name = dataset_name
    # `<name>_max<N>`: size-filtered VIEW keeping graphs with <= N nodes
    # (applied AFTER splitting, so split membership matches the unfiltered
    # name). Used where exact truth is infeasible on the largest graphs —
    # e.g. the big tree-shaped queries 8006/10006/12006, whose occurrence
    # counts explode combinatorially on 800-node graphs.
    max_nodes = None
    m = re.search(r"_max(\d+)", name)
    if m:
        max_nodes = int(m.group(1))
        name = name.replace(m.group(0), "")
    split = None
    for s in ("_train", "_val", "_test"):
        if s in name:
            split = s[1:]
            name = name.replace(s, "")
            break
    relabel = None
    for s, mode in (
        ("_decreaseByDegree", "decreasing_degree"),
        ("_increaseByDegree", "increasing_degree"),
        ("_random", "random"),
    ):
        if s in name:
            relabel = mode
            name = name.replace(s, "")
            break

    syn_np = _SYN_NP.fullmatch(name)
    if syn_np is not None:
        n_graphs, seed = int(syn_np.group(1)), int(syn_np.group(2) or 0)
        if n_graphs < 1:
            raise ValueError(f"dataset {dataset_name!r} has no graphs")
        graphs = random_connected_graphs(n_graphs,
                                         np.random.default_rng(seed))
    elif name.startswith("Syn_"):
        n = int(name.split("_")[1])
        graphs = load_or_generate_synthetic(
            n, os.path.join(root_folder, name), min_size=10, max_size=500)
    elif name.startswith("syn_"):
        # legacy lowercase synthetic names: the deepsnap-ensemble mix
        # (ER-beta/WS/extended-BA/powerlaw-cluster, uniform 1/4 each)
        # with sizes 6-41
        n = int(name.split("_")[1])
        graphs = load_or_generate_synthetic(
            n, os.path.join(root_folder, name), min_size=5, max_size=41,
            recipe="combined")
    elif name in TU_PROXY_RECIPES:
        # structural stand-ins for the unobtainable TU benchmarks
        # (tu_proxy.py docstring; results on these are labeled proxies)
        graphs = load_or_generate_proxy(name, os.path.join(root_folder, name))
    elif name in TU_NAMES:
        graphs = load_tu_dataset(root_folder, TU_NAMES[name], with_labels)
    elif name in ("P2P", "Astro"):
        graphs = load_snap_edgelist(root_folder, name)
    elif name in ("Cora", "CiteSeer"):
        try:
            graphs = load_planetoid(root_folder, name)
        except (FileNotFoundError, ImportError):
            # fallback: a pre-exported bare edge list. ImportError: the
            # primary loader needs scipy, an optional dependency
            graphs = load_snap_edgelist(root_folder, name)
    elif name == "ZINC":
        try:
            graphs = load_zinc(root_folder)
        except (FileNotFoundError, ImportError):  # pickles need torch
            graphs = load_snap_edgelist(root_folder, name)
    elif name == "arXiv":
        try:
            graphs = load_ogb_arxiv(root_folder)
        except (FileNotFoundError, ImportError):
            graphs = load_snap_edgelist(root_folder, name)
    else:
        raise NotImplementedError(f"unknown dataset: {name}")

    if relabel:
        graphs = _relabel_all(graphs, relabel)

    if split is not None:
        # fixed-seed shuffled split, as desco_tpu splits
        idx = list(range(len(graphs)))
        random.Random(0).shuffle(idx)
        train_len = int(len(graphs) * TRAIN_SPLIT)
        val_len = int(len(graphs) * VAL_SPLIT)
        if split == "train":
            sel = idx[:train_len]
        elif split == "val":
            sel = idx[train_len:train_len + val_len]
        else:
            sel = idx[train_len + val_len:]
        graphs = [graphs[i] for i in sel]
    if max_nodes is not None:
        graphs = [g for g in graphs if g.n_nodes <= max_nodes]
    return graphs
