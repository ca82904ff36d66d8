"""The port's data layer against desco_tpu's: generated datasets graph for
graph and edge for edge (``Syn_<n>``, ``syn_<n>``, the TU proxies), the
Syn_1827 splits against their published fingerprints, ``load_data``'s
names and suffixes, the file readers on tiny files written here, the
truth shards and the neighborhood sample cache (each package reads the
other's). Every cache lives under ``tmp_path``: no test writes under the
repository's ``data/``."""

import gzip
import os
import pickle
import random
import shutil

import numpy as np
import pytest

from desco_tpu.data import datasets as jds
from desco_tpu.data import synthetic as jsyn
from desco_tpu.data import tu_proxy as jtu
from desco_tpu.data.workload import Workload as JWorkload
from desco_tpu.graph.atlas import gen_query_ids
from desco_tpu_torch.data import synthetic as tsyn
from desco_tpu_torch.data import tu_proxy as ttu
from desco_tpu_torch.data.datasets import fingerprint, load_data
from desco_tpu_torch.data.workload import Workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_ROOT = os.path.join(REPO, "tests", "data")
QIDS = gen_query_ids([3, 4])
# desco_tpu's Syn_1827 and its splits, made with networkx 3.6.1 (graphs,
# nodes, edges, fingerprint)
SYN_1827 = {
    "Syn_1827": (1827, 246542, 661491, "be4812bf6c8a03a8"),
    "Syn_1827_test": (915, 127309, 348718, "4ec80206fa8ffa4d"),
    "Syn_1827_train": (456, 59044, 153236, "686c7bf4219cab0e"),
    "Syn_1827_val": (456, 60189, 159537, "b10ec9b16f85ee01"),
    "Syn_1827_test_max40": (354, 8798, 46757, "48cfc9793f8ad2ca"),
}


def summary(graphs):
    return (len(graphs), sum(g.n_nodes for g in graphs),
            sum(g.n_edges for g in graphs), fingerprint(graphs))


def assert_same_graphs(mine, theirs, same_order=True):
    assert len(mine) == len(theirs)
    for g, h in zip(mine, theirs):
        assert g.n_nodes == h.n_nodes
        if same_order:
            assert np.array_equal(g.edges, h.edges)
        else:
            assert fingerprint([g]) == fingerprint([h])
        if h.node_feat is None:
            assert g.node_feat is None
        else:
            np.testing.assert_array_equal(g.node_feat, h.node_feat)


# ------------------------------------------------------------ generation
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("sizes", [(5, 20), (10, 60), (40, 200)])
def test_generate_synthetic_matches_desco_tpu(seed, sizes):
    assert_same_graphs(tsyn.generate_synthetic(24, *sizes, seed=seed),
                       jsyn.generate_synthetic(24, *sizes, seed=seed))


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_syn_1827_samplers_match_desco_tpu(seed):
    """The stratified grid's draws (the whole recipe is held by the
    fingerprints below)."""
    rng_t, rng_j = (np.random.default_rng(seed) for _ in range(2))
    tn, ta = tsyn._syn_1827_samplers(rng_t)
    jn, ja = jsyn._syn_1827_samplers(rng_j)
    for sid in list(range(0, 1827, 7)) + [1379, 1380, 1826]:
        assert tn(sid) == jn(sid) and ta(sid) == ja(sid)


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_generate_combined_syn_matches_desco_tpu(seed):
    assert_same_graphs(tsyn.generate_combined_syn(80, seed=seed),
                       jsyn.generate_combined_syn(80, seed=seed))


def test_syn_1000_matches_desco_tpu():
    mine = tsyn.generate_combined_syn(1000)
    assert summary(mine) == (1000, 23293, 75728, "198c0daa3c6ff3bd")
    assert_same_graphs(mine, jsyn.generate_combined_syn(1000))


@pytest.mark.parametrize("name", sorted(ttu.TU_PROXY_RECIPES))
def test_tu_proxy_matches_desco_tpu(name):
    fn, count, kwargs = ttu.TU_PROXY_RECIPES[name]
    jfn = jtu.TU_PROXY_RECIPES[name][0]
    assert jtu.TU_PROXY_RECIPES[name][1:] == (count, kwargs)
    assert_same_graphs(fn(count, seed=0, **kwargs),
                       jfn(count, seed=0, **kwargs))
    assert_same_graphs(fn(12, seed=3, **kwargs), jfn(12, seed=3, **kwargs))


def test_tu_proxy_cache_quirk(tmp_path):
    """The generating run returns the graphs in memory, later runs the
    read-back: the same edge sets, as desco_tpu has it."""
    first = ttu.load_or_generate_proxy("ChemProxy", str(tmp_path / "t"))
    again = ttu.load_or_generate_proxy("ChemProxy", str(tmp_path / "t"))
    theirs = jtu.load_or_generate_proxy("ChemProxy", str(tmp_path / "j"))
    assert_same_graphs(first, theirs)
    assert_same_graphs(again, theirs, same_order=False)
    assert summary(again) == (188, 3541, 3653, "69ed3dc0de93263b")


@pytest.fixture(scope="module")
def syn_1827_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("syn1827"))
    load_data("Syn_1827", root)
    return root


@pytest.mark.parametrize("name", sorted(SYN_1827))
def test_syn_1827_fingerprints(syn_1827_root, name):
    assert summary(load_data(name, syn_1827_root)) == SYN_1827[name]


def test_syn_64_cache_matches_desco_tpu(tmp_path):
    """``Syn_64`` (the name desco_tpu's own tests cache) read back from
    each package's cache, and the read-back against the generator."""
    mine = tsyn.load_or_generate_synthetic(64, str(tmp_path / "t"))
    assert_same_graphs(mine, jsyn.load_or_generate_synthetic(
        64, str(tmp_path / "j")))
    assert fingerprint(mine) == fingerprint(tsyn.generate_synthetic(64))


def test_cache_files_equal_desco_tpus(tmp_path):
    """Both packages write the same raw files and read them back alike."""
    tsyn.load_or_generate_synthetic(30, str(tmp_path / "t"), 10, 40, seed=4)
    jsyn.load_or_generate_synthetic(30, str(tmp_path / "j"), 10, 40, seed=4)
    for a, b in zip(tsyn.raw_paths(str(tmp_path / "t")),
                    tsyn.raw_paths(str(tmp_path / "j"))):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
    assert_same_graphs(
        tsyn.read_edge_list_dataset(*tsyn.raw_paths(str(tmp_path / "j"))),
        jsyn.read_edge_list_dataset(*tsyn.raw_paths(str(tmp_path / "t"))))


# --------------------------------------------------------------- loading
@pytest.fixture(scope="module")
def syn_64_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("syn64"))
    tsyn.load_or_generate_synthetic(64, os.path.join(root, "Syn_64"))
    return root


@pytest.mark.parametrize("suffix", [
    "", "_train", "_val", "_test", "_max30", "_test_max40",
    "_decreaseByDegree", "_increaseByDegree", "_random",
    "_random_train", "_decreaseByDegree_val_max50"])
def test_load_data_suffixes_match_desco_tpu(syn_64_root, suffix):
    name = "Syn_64" + suffix
    assert_same_graphs(load_data(name, syn_64_root),
                       jds.load_data(name, syn_64_root))


@pytest.mark.parametrize("name", ["syn_40_test", "ChemProxy_max20",
                                  "EgoProxy_increaseByDegree_train"])
def test_load_data_generated_names_match_desco_tpu(tmp_path, name):
    assert_same_graphs(load_data(name, str(tmp_path / "t")),
                       jds.load_data(name, str(tmp_path / "j")),
                       same_order=False)


def test_synnp_takes_the_suffixes():
    full = load_data("SynNp_8_3")
    idx = list(range(8))
    random.Random(0).shuffle(idx)
    for split, sel in (("train", slice(0, 2)), ("val", slice(2, 4)),
                       ("test", slice(4, None))):
        want = [full[i] for i in idx[sel]]
        assert_same_graphs(load_data(f"SynNp_8_3_{split}"), want)
    small = [g for g in full if g.n_nodes <= 40]
    assert 0 < len(small) < len(full)
    assert_same_graphs(load_data("SynNp_8_3_max40"), small)


def test_tu_files_with_labels_match_desco_tpu():
    for name in ("MUTAG", "MUTAG_test"):
        for labels in (False, True):
            assert_same_graphs(
                load_data(name, FIXTURE_ROOT, with_labels=labels),
                jds.load_data(name, FIXTURE_ROOT, with_labels=labels))


def test_snap_edge_list(tmp_path):
    raw = tmp_path / "P2P" / "raw"
    raw.mkdir(parents=True)
    (raw / "edges.txt").write_text(
        "# comment\n10 20\n20 30\n30 10\n20 10\n40 40\n50 10\n")
    mine = load_data("P2P", str(tmp_path))
    assert mine[0].n_nodes == 5 and mine[0].n_edges == 4
    assert_same_graphs(mine, jds.load_data("P2P", str(tmp_path)))


def _write_planetoid(raw):
    import scipy.sparse as sp

    raw.mkdir(parents=True)
    f = 5
    objs = {
        "allx": sp.csr_matrix(np.arange(20, dtype=np.float32).reshape(4, f)),
        "tx": sp.csr_matrix(np.array([[60] * f, [40] * f, [50] * f],
                                     dtype=np.float32)),
        "ally": np.eye(3, dtype=np.float32)[[0, 1, 2, 0]],
        "ty": np.eye(3, dtype=np.float32)[[2, 0, 1]],
        "graph": {0: [1, 4], 1: [0, 2], 2: [1, 3], 3: [2], 4: [0, 5],
                  5: [4, 6], 6: [5]},
    }
    for name, obj in objs.items():
        with open(raw / f"ind.cora.{name}", "wb") as fh:
            pickle.dump(obj, fh)
    (raw / "ind.cora.test.index").write_text("6\n4\n5\n")


def test_planetoid(tmp_path):
    _write_planetoid(tmp_path / "Cora" / "raw")
    [g] = mine = load_data("Cora", str(tmp_path))
    assert g.n_nodes == 7 and g.n_edges == 6 and g.node_feat[6, -1] == 2.0
    assert_same_graphs(mine, jds.load_data("Cora", str(tmp_path)))


def test_zinc(tmp_path):
    raw = tmp_path / "ZINC" / "raw"
    raw.mkdir(parents=True)
    mols = []
    for n in (4, 5, 7):
        bond = np.zeros((n, n), np.int64)
        for i in range(n - 1):
            bond[i, i + 1] = bond[i + 1, i] = 1
        mols.append({"num_atom": n,
                     "atom_type": np.arange(n, dtype=np.int64) % 3,
                     "bond_type": bond})
    with open(raw / "train.pickle", "wb") as fh:
        pickle.dump(mols[:2], fh)
    with open(raw / "test.pickle", "wb") as fh:
        pickle.dump(mols[2:], fh)
    mine = load_data("ZINC", str(tmp_path))
    assert [g.n_nodes for g in mine] == [4, 5, 7]
    assert mine[0].node_feat.shape == (4, 28)
    assert_same_graphs(mine, jds.load_data("ZINC", str(tmp_path)))


def test_ogb_arxiv(tmp_path):
    raw = tmp_path / "arXiv" / "raw"
    raw.mkdir(parents=True)

    def wr(name, arr):
        with gzip.open(raw / name, "wt") as fh:
            for row in np.atleast_2d(arr):
                fh.write(",".join(str(float(v)) for v in row) + "\n")

    wr("edge.csv.gz", np.array([[0, 1], [1, 2], [2, 0], [1, 1], [1, 0]]))
    wr("node-feat.csv.gz", np.arange(12, dtype=np.float32).reshape(3, 4))
    wr("node-label.csv.gz", np.array([[0.0], [1.0], [2.0]]))
    [g] = mine = load_data("arXiv", str(tmp_path))
    assert g.n_nodes == 3 and g.n_edges == 3 and g.node_feat.shape == (3, 5)
    assert_same_graphs(mine, jds.load_data("arXiv", str(tmp_path)))


@pytest.mark.parametrize("name", ["Cora", "ZINC", "arXiv"])
def test_featured_loaders_fall_back_to_an_edge_list(tmp_path, name):
    raw = tmp_path / name / "raw"
    raw.mkdir(parents=True)
    (raw / "edges.txt").write_text("0 1\n1 2\n")
    mine = load_data(name, str(tmp_path))
    assert mine[0].n_nodes == 3 and mine[0].n_edges == 2
    assert_same_graphs(mine, jds.load_data(name, str(tmp_path)))


@pytest.mark.parametrize("name,path", [
    ("MUTAG", "MUTAG/raw"), ("COX2", "COX2/raw"), ("MSRC-21", "MSRC_21/raw"),
    ("P2P", "P2P/raw/edges.txt"), ("Cora", "Cora/raw/edges.txt"),
    ("ZINC", "ZINC/raw/edges.txt"), ("arXiv", "arXiv/raw/edges.txt")])
def test_missing_files_raise_naming_the_path(tmp_path, name, path):
    with pytest.raises(FileNotFoundError) as err:
        load_data(name, str(tmp_path))
    assert os.path.join(str(tmp_path), path) in str(err.value)
    assert not os.listdir(tmp_path)  # nothing fetched, nothing written


@pytest.mark.parametrize("name", ["SynNp_x", "Foo", "SynNp_0", "Syn_x"])
def test_unknown_names_raise(name):
    exc = {"SynNp_0": ValueError, "Syn_x": ValueError}.get(
        name, NotImplementedError)
    with pytest.raises(exc):
        load_data(name)
    if name not in ("SynNp_x", "SynNp_0"):
        with pytest.raises(exc):
            jds.load_data(name)


# ---------------------------------------------------------------- caches
@pytest.fixture(scope="module")
def small_set():
    return tsyn.generate_synthetic(12, 8, 30, seed=11)


def test_truth_shards_merge_to_the_full_truth(tmp_path, small_set):
    wl = Workload(small_set, root=str(tmp_path / "t"))
    full = wl.compute_groundtruth(QIDS, use_cache=False)
    paths = [wl.compute_groundtruth_shard(QIDS, k, 3) for k in range(3)]
    assert all(os.path.exists(p) for p in paths)
    merged = wl.merge_groundtruth_shards(QIDS, 3)
    np.testing.assert_array_equal(merged, full)
    for p in paths:
        os.remove(p)
    np.testing.assert_array_equal(np.load(wl.groundtruth_path(QIDS)), full)
    # desco_tpu merges the port's shards, and the port desco_tpu's
    jwl = JWorkload(small_set, root=str(tmp_path / "j"))
    for k in range(2):
        wl.compute_groundtruth_shard(QIDS, k, 2)
        jwl.compute_groundtruth_shard(QIDS, k, 2)
    shutil.copytree(tmp_path / "t", tmp_path / "t2")
    np.testing.assert_array_equal(
        JWorkload(small_set, root=str(tmp_path / "t2"))
        .merge_groundtruth_shards(QIDS, 2), full)
    np.testing.assert_array_equal(
        Workload(small_set, root=str(tmp_path / "j"))
        .merge_groundtruth_shards(QIDS, 2), full)


def test_truth_shards_refuse_gaps(tmp_path, small_set):
    wl = Workload(small_set, root=str(tmp_path))
    with pytest.raises(ValueError):
        wl.compute_groundtruth_shard(QIDS, 3, 3)
    wl.compute_groundtruth_shard(QIDS, 0, 2)
    with pytest.raises(FileNotFoundError, match="shard1of2"):
        wl.merge_groundtruth_shards(QIDS, 2)


def assert_same_samples(a, b):
    (sa, ia), (sb, ib) = a, b
    np.testing.assert_array_equal(ia.index, ib.index)
    np.testing.assert_array_equal(ia.indicator, ib.indicator)
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        for field in ("node_type", "x", "edge_src", "edge_dst",
                      "edge_type", "y"):
            np.testing.assert_array_equal(getattr(x, field),
                                          getattr(y, field))


def test_sample_cache_round_trips(tmp_path, small_set):
    wl = Workload(small_set, root=str(tmp_path))
    truth = wl.compute_groundtruth(QIDS)
    fresh = wl.neighborhood_samples(3, truth=truth)
    written = wl.neighborhood_samples(3, truth=truth, use_cache=True)
    cache = wl._neigh_cache_path(3, True)
    assert os.path.isdir(cache)
    read = wl.neighborhood_samples(3, truth=truth, use_cache=True)
    assert isinstance(read[0][0].edge_src, np.memmap)
    assert_same_samples(written, fresh)
    assert_same_samples(read, fresh)


def test_sample_caches_cross_packages(tmp_path, small_set):
    """desco_tpu reads the port's sample cache and the port desco_tpu's,
    with equal samples."""
    t_root, j_root = str(tmp_path / "t"), str(tmp_path / "j")
    wl, jwl = Workload(small_set, root=t_root), JWorkload(small_set, j_root)
    truth = wl.compute_groundtruth(QIDS)
    mine = wl.neighborhood_samples(4, truth=truth, use_cache=True)
    theirs = jwl.neighborhood_samples(4, QIDS, truth=truth)
    assert sorted(os.listdir(os.path.join(t_root, "NeighborhoodDataset"))) \
        == sorted(os.listdir(os.path.join(j_root, "NeighborhoodDataset")))
    assert_same_samples(mine, theirs)
    shutil.rmtree(os.path.join(t_root, "CanonicalCountTruth"))
    swapped_t, swapped_j = str(tmp_path / "t_reads_j"), str(
        tmp_path / "j_reads_t")
    shutil.copytree(j_root, swapped_t)
    shutil.copytree(t_root, swapped_j)
    read_by_port = Workload(small_set, root=swapped_t).neighborhood_samples(
        4, truth=truth, use_cache=True)
    read_by_j = JWorkload(small_set, swapped_j).neighborhood_samples(
        4, QIDS, truth=truth)
    assert isinstance(read_by_port[0][0].edge_src, np.memmap)
    assert isinstance(read_by_j[0][0].edge_src, np.memmap)
    assert_same_samples(read_by_port, theirs)
    assert_same_samples(read_by_j, mine)


def test_stale_sample_cache_is_rebuilt(tmp_path, small_set):
    root = str(tmp_path)
    Workload(small_set, root=root).neighborhood_samples(3, use_cache=True)
    fewer = small_set[:5]
    with pytest.warns(UserWarning, match="does not match"):
        got = Workload(fewer, root=root).neighborhood_samples(
            3, use_cache=True)
    assert_same_samples(got, Workload(fewer).neighborhood_samples(3))
