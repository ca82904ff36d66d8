"""The port's analysis and experimental tools (desco_tpu_torch/tools/)
against desco_tpu's root scripts, on the CPU at small sizes: the same
data from the same seeds, desco_tpu's weights carried over with
``params_from_jax`` where a tool draws fresh ones.

Tolerances: counts rtol 1e-3 (atol 1e-2 for a de-logged count near
zero, as tests/test_torch_serving.py); normed MSE rtol 1e-3; tower
outputs 1e-4 of max|out|; exact truth, partitions, features and
printed lines equal (features within 1e-9: float sums in another
order); PCA 1e-5 of sklearn; the t-SNE joint P 1e-6 of sklearn's, its
final KL at most 1.2 x sklearn's t-SNE on the same points (the exact
gradient against sklearn's Barnes-Hut approximation, the script's
method)."""

import contextlib
import csv
import dataclasses
import io
import pickle
import runpy
import sys

import jax
import networkx as nx
import numpy as np
import pytest
import torch

from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch.tools import (
    complexity_analysis, compute_groundtruth, dataset_statistics,
    downstream_task, large_graph_serving, runtime, scaling, serving_bench,
    verify_sweep)
from desco_tpu_torch.train.checkpoint import params_from_jax
from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)

NEIGH, GOSSIP = "release/r4/neigh.best", "release/r4/gossip.best"
TOOLS = {"serving_bench": serving_bench,
         "compute_groundtruth": compute_groundtruth,
         "verify_sweep": verify_sweep, "scaling": scaling,
         "large_graph_serving": large_graph_serving, "runtime": runtime,
         "complexity_analysis": complexity_analysis,
         "downstream_task": downstream_task,
         "dataset_statistics": dataset_statistics}
QUIET = dict(log=lambda *a: None)


def args_of(tool, *argv):
    return tool.build_parser().parse_args([*map(str, argv)])


def run_script(path, *argv):
    """desco_tpu's root script as ``python <path> argv``: its stdout."""
    old = sys.argv
    sys.argv = [path, *map(str, argv)]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old
    assert not e.value.code, buf.getvalue()[-2000:]
    return buf.getvalue()


def carried(tree):
    return params_from_jax(_flatten(tree))


# ------------------------------------------------------------ every tool
@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_on_the_card_by_default(name):
    """No ``--device``: the card, and without one the tool raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs on it")
    argv = {"verify_sweep": ["--dataset", "x", "--neigh_checkpoint", "x"]}
    with pytest.raises(RuntimeError, match="CUDA device"):
        TOOLS[name].main(argv.get(name, []))


# --------------------------------------------------- compute_groundtruth
@pytest.mark.parametrize("how", ["sizes", "ids", "pickle"])
def test_groundtruth_csv_equals_the_script(tmp_path, how):
    if how == "pickle":
        qs = [nx.cycle_graph(4), nx.path_graph(5), nx.complete_graph(4)]
        path = tmp_path / "q.p"
        path.write_bytes(pickle.dumps(qs))
        sel = ["--queries_pickle", path]
    else:
        sel = (["--query_sizes", 6] if how == "sizes"
               else ["--query_ids", 6, 8001, 100])
    common = ["--dataset", "syn_6", *sel]
    run_script("analysis/compute_groundtruth.py", *common, "--data_root",
               tmp_path / "j", "--output", tmp_path / "j.csv")
    got = compute_groundtruth.run(args_of(
        compute_groundtruth, *common, "--data_root", tmp_path / "t",
        "--output", tmp_path / "t.csv", "--device", "cpu"), **QUIET)
    assert (tmp_path / "t.csv").read_bytes() == (
        tmp_path / "j.csv").read_bytes()
    if how == "sizes":
        assert len(got["query_ids"]) == 112 and set(got["sizes"]) == {6}
    assert (got["truth"] >= 0).all()


def test_groundtruth_pickle_without_networkx_names_it(tmp_path,
                                                      monkeypatch):
    path = tmp_path / "q.p"
    path.write_bytes(pickle.dumps([nx.path_graph(3)]))
    monkeypatch.setitem(sys.modules, "networkx", None)
    with pytest.raises(RuntimeError, match="networkx"):
        compute_groundtruth.run(args_of(
            compute_groundtruth, "--dataset", "syn_2", "--queries_pickle",
            path, "--data_root", tmp_path, "--device", "cpu"), **QUIET)


# --------------------------------------------------- complexity_analysis
def test_complexity_lines_equal_the_script(tmp_path):
    want = run_script("experimental/complexity_analysis.py", "--dataset",
                      "Syn_8", "--data_root", tmp_path / "j")
    lines = []
    got = complexity_analysis.run(args_of(
        complexity_analysis, "--dataset", "Syn_8", "--data_root",
        tmp_path / "t", "--device", "cpu"), log=lines.append)
    assert "\n".join(lines) + "\n" == want
    assert got["graphs"] == 8 and set(got["sums"]) == {"n^2", "2^n", "n*n!"}


# ---------------------------------------------------------- verify_sweep
def test_verify_sweep_matches_desco_tpu(tmp_path):
    from desco_tpu.data.datasets import load_data as j_load
    from desco_tpu.models import neighborhood as jneigh
    from desco_tpu.pipeline import (
        PipelineConfig, build_query_batch, evaluate_graphlet_counts,
        model_configs, neighborhood_predictions, prepare_stage_data,
        verify_tail_counts)
    from desco_tpu.train.checkpoint import load_checkpoint

    budgets = [0.0, 1e-3, 1e-2, 3e-2]
    ds, jroot = "syn_8", str(tmp_path / "j")
    cfg = PipelineConfig(data_root=jroot)
    tgt, qry = model_configs(cfg)
    params = load_checkpoint(NEIGH, jneigh.init_neighborhood_model(
        jax.random.PRNGKey(0), tgt, qry))[0]
    stage = prepare_stage_data(cfg, j_load(ds, jroot), ds)
    raw = neighborhood_predictions(
        params, tgt, qry, build_query_batch(cfg), stage,
        dataclasses.replace(cfg, verify_budget=0.0))
    got = verify_sweep.run(args_of(
        verify_sweep, "--dataset", ds, "--neigh_checkpoint", NEIGH,
        "--data_root", tmp_path / "t", "--device", "cpu"), **QUIET)
    assert got["neighborhoods"] == raw.shape[0]
    for row, b in zip(got["rows"], budgets):
        if b > 0:
            counts, verified = verify_tail_counts(
                raw.copy(), stage, dataclasses.replace(cfg, verify_budget=b))
        else:
            counts, verified = raw, np.zeros(0)
        want = evaluate_graphlet_counts(cfg, stage, counts)
        assert row["budget"] == b
        assert row["rows_verified"] == len(verified) > (0 if b else -1)
        np.testing.assert_allclose(row["norm_mse"],
                                   want["norm_mse_neighborhood"],
                                   rtol=1e-3, atol=1e-12)


# --------------------------------------------------------- serving_bench
def test_serving_bench_raw_matches_desco_tpu(tmp_path):
    from desco_tpu.data.synthetic import generate_synthetic
    from desco_tpu.models import neighborhood as jneigh
    from desco_tpu.models.gossip import init_gossip_model
    from desco_tpu.pipeline import (
        PipelineConfig, build_query_batch, model_configs,
        neighborhood_predictions, prepare_gossip_batches,
        prepare_stage_data)
    from desco_tpu.train.loop import predict_gossip_counts

    graphs = generate_synthetic(4, min_size=30, max_size=120, seed=7)
    cfg = PipelineConfig(data_root=str(tmp_path), clamp_counts=True,
                         verify_budget=0.001)
    tgt, qry = model_configs(cfg)
    qb = build_query_batch(cfg)
    params = jneigh.init_neighborhood_model(jax.random.PRNGKey(0), tgt, qry)
    gparams = init_gossip_model(jax.random.PRNGKey(1), input_dim=1,
                                hidden_dim=64, emb_channels=64, layer_num=2)
    stage = prepare_stage_data(cfg, graphs, "serve_bench", need_truth=False)
    counts, _ = neighborhood_predictions(params, tgt, qry, qb, stage, cfg,
                                         return_verified=True)
    gb = prepare_gossip_batches(cfg, stage, counts)
    nc = predict_gossip_counts(
        gparams, jneigh.embed_queries(params, qry, qb), gb)
    want = stage.workload.aggregate_node_counts(nc)
    got = serving_bench.run(
        args_of(serving_bench, "--graphs", 4, "--device", "cpu"),
        weights=(carried(params), carried(gparams)), **QUIET)
    assert got["graphs"] == 4 and got["nodes"] == sum(
        g.n_nodes for g in graphs)
    np.testing.assert_allclose(got["graphlet_counts"], want, rtol=1e-3,
                               atol=1e-2)
    assert got["graphs_per_s"] > 0 and got["host_s"] > 0


@pytest.mark.parametrize("mode", ["service", "stream", "latency"])
def test_serving_bench_modes_run(mode):
    got = serving_bench.run(args_of(
        serving_bench, "--graphs", 4, "--requests", 2, "--mode", mode,
        "--device", "cpu"), **QUIET)
    assert got["mode"] == mode and got["cold_s"] > 0
    if mode == "service":
        res = got["result"]
        assert res.graphlet_counts.shape == (4, 29)
        assert np.isfinite(res.graphlet_counts).all()
        assert (res.graphlet_counts >= 0).all()
    elif mode == "stream":
        assert len(got["results"]) == 2 and got["overlap_gain"] > 0
        for a, b in zip(got["results"], got["sequential_results"]):
            np.testing.assert_array_equal(a.graphlet_counts,
                                          b.graphlet_counts)
    else:
        lat = got["latency_ms"]
        assert 0 < got["min_ms"] <= lat[50] <= lat[90] <= lat[99] <= got[
            "max_ms"]


def test_serving_bench_ensemble_and_exact_size(tmp_path):
    got = serving_bench.run(args_of(
        serving_bench, "--graphs", 3, "--mode", "service", "--neigh_ckpt",
        NEIGH, NEIGH, "--gossip_ckpt", GOSSIP, "--exact_size", 3,
        "--n_devices", 2, "--device", "cpu"), **QUIET)
    res = got["result"]
    assert res.graphlet_counts.shape == (3, 29)
    assert np.isfinite(res.graphlet_counts).all()


# -------------------------------------------------------------- scaling
def j_typed_graph(kind, n, degree=8, locality="metis"):
    """desco_tpu's scaling script's graph, as its main() builds it."""
    from desco_tpu.batch.build import neighborhood_sample
    from desco_tpu.graph.canonical import Neighborhood
    from desco_tpu.graph.container import Graph
    from desco_tpu.parallel.halo import locality_order

    script = runpy.run_path("analysis/scaling.py")
    rng = np.random.default_rng(0)
    raw = script["build_graph"](kind, n, degree, rng)
    pm = rng.permutation(n).astype(np.int32)
    s = neighborhood_sample(Neighborhood(
        graph=Graph(n, pm[raw]), canonical=n - 1,
        nodes=np.arange(n, dtype=np.int32)))
    order = locality_order(n, s.edge_src, s.edge_dst, method=locality)
    inv = np.empty_like(order)
    inv[order] = np.arange(n)
    return (n, s.node_type[order], s.x[order],
            inv[s.edge_src].astype(np.int32),
            inv[s.edge_dst].astype(np.int32), s.edge_type, s.n_edges)


@pytest.mark.parametrize("kind", ["er", "ba", "rgg", "comm"])
def test_scaling_graphs_and_partitions_equal_the_script(kind):
    from desco_tpu.parallel import halo as jhalo
    from desco_tpu_torch.parallel import halo

    script = runpy.run_path("analysis/scaling.py")
    want = script["build_graph"](kind, 500, 8, np.random.default_rng(0))
    got = scaling.build_graph(kind, 500, 8, np.random.default_rng(0))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    j = j_typed_graph(kind, 500)
    t = scaling.typed_graph(args_of(scaling, "--graph", kind, "--nodes",
                                    500), np.random.default_rng(0))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    for d in (1, 2, 4):
        jp = jhalo.partition_typed_graph(*j[:6], d, n_types=6)
        tp = halo.partition_typed_graph(*t[:6], d, n_types=6)
        assert (tp.h_max, tp.p_max) == (jp.h_max, jp.p_max), d


def test_scaling_halo_core_matches_desco_tpu():
    from functools import partial

    from jax.sharding import Mesh, PartitionSpec as P

    from desco_tpu.models.shmp_gnn import init_shmp, \
        neighborhood_target_config
    from desco_tpu.parallel import halo as jhalo

    j = j_typed_graph("comm", 500)
    jcfg = neighborhood_target_config(layer_num=4, hidden_dim=64)
    jparams = init_shmp(jax.random.PRNGKey(0), jcfg)
    part = jhalo.partition_typed_graph(*j[:6], 2, n_types=6)
    mesh = Mesh(np.array(jax.devices()[:2]), ("graph",))

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("graph")),
             out_specs=P("graph"))
    def run(params, shard):
        shard = jax.tree_util.tree_map(lambda a: a[0], shard)
        return jhalo.halo_shmp_core(params, jcfg, shard)[None]

    with mesh:
        want = jhalo.unpartition_nodes(
            part, np.asarray(jax.jit(run)(jparams, part)))
    got = scaling.run(args_of(
        scaling, "--graph", "comm", "--nodes", 500, "--devices", 2,
        "--reps", 1, "--device", "cpu"), params=carried(jparams), **QUIET)
    row = got["rows"][0]
    assert row["d"] == 2 and (row["pull_pair"], row["push_pair"]) == (
        part.h_max, part.p_max)
    assert row["ms_fwd"] > 0 and 0 < row["comm"]
    np.testing.assert_allclose(got["out"][2], want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


# -------------------------------------------------- large_graph_serving
def test_large_graph_serving_matches_desco_tpu(tmp_path):
    from desco_tpu.graph.container import Graph
    from desco_tpu.models import neighborhood as jneigh
    from desco_tpu.models.gossip import init_gossip_model
    from desco_tpu.parallel.halo import serve_gossip_counts
    from desco_tpu.pipeline import (
        PipelineConfig, build_query_batch, model_configs,
        neighborhood_predictions, prepare_stage_data)

    g = large_graph_serving.ba_graph(300, 4, 3)
    jg = Graph(g.n_nodes, g.edges.copy())
    cfg = PipelineConfig(query_sizes=(3,), data_root=str(tmp_path),
                         clamp_counts=False, verify_budget=0.0)
    tgt, qry = model_configs(cfg)
    qb = build_query_batch(cfg)
    params = jneigh.init_neighborhood_model(jax.random.PRNGKey(0), tgt, qry)
    gparams = init_gossip_model(jax.random.PRNGKey(1), input_dim=1,
                                hidden_dim=64, emb_channels=64, layer_num=2)
    stage = prepare_stage_data(cfg, [jg], "lgs", need_truth=False)
    counts = neighborhood_predictions(params, tgt, qry, qb, stage, cfg)
    x_all = np.zeros((jg.n_nodes, counts.shape[1]), np.float32)
    x_all[np.asarray(stage.nindex.indicator)] = counts.astype(np.float32)
    want = serve_gossip_counts(gparams, jg, x_all,
                               jneigh.embed_queries(params, qry, qb),
                               n_devices=2)
    got = large_graph_serving.run(args_of(
        large_graph_serving, "--nodes", 300, "--devices", 2, "--device",
        "cpu"), weights=(carried(params), carried(gparams)), **QUIET)
    assert got["n_devices"] == 2 and got["n_loc"] < 300
    np.testing.assert_allclose(got["result"].node_counts, want, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        got["graphlet"], np.maximum(np.round(want), 0).sum(0), atol=1)


# --------------------------------------------------------------- runtime
def test_runtime_matches_desco_tpu(tmp_path):
    from desco_tpu.batch.packed import auto_capacities, pack_samples
    from desco_tpu.data.datasets import load_data as j_load
    from desco_tpu.data.workload import Workload
    from desco_tpu.models.shmp_gnn import (
        apply_shmp, init_shmp, neighborhood_target_config)

    root = str(tmp_path / "j")
    wl = Workload(j_load("Syn_8", root), root=f"{root}/Syn_8", name="Syn_8")
    samples, _ = wl.neighborhood_samples(
        4, [6, 7], truth=np.zeros((wl.total_nodes, 2)))
    batch = pack_samples(samples, *auto_capacities(samples, g_cap=32),
                         n_queries=2)[0]
    jcfg = neighborhood_target_config(layer_num=8, hidden_dim=64,
                                      output_dim=64)
    jparams = init_shmp(jax.random.PRNGKey(0), jcfg)
    want = np.asarray(apply_shmp(jparams, jcfg, batch))
    got = runtime.run(args_of(
        runtime, "--dataset", "Syn_8", "--data_root", tmp_path / "t",
        "--reps", 1, "--device", "cpu"), params=carried(jparams), **QUIET)
    nm = np.asarray(batch.node_mask)
    assert got["valid_edges"] == int((nm[np.asarray(batch.edge_src)]
                                      > 0).sum())
    assert got["graphs"] == int(np.asarray(batch.graph_mask).sum()) == 32
    np.testing.assert_allclose(got["out"], want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert got["ms"] > 0


# ------------------------------------------------------ downstream_task
def test_downstream_task_matches_the_script(tmp_path):
    from desco_tpu.data.datasets import load_data as j_load
    from desco_tpu.data.workload import Workload
    from desco_tpu.graph.atlas import gen_query_ids
    from desco_tpu.models.init import mlp_params

    root = str(tmp_path / "j")
    out = run_script("experimental/downstream_task.py", "--dataset",
                     "Syn_8", "--data_root", root, "--epochs", 60)
    truth = Workload(j_load("Syn_8", root), root=f"{root}/Syn_8",
                     name="Syn_8").compute_groundtruth(gen_query_ids([3, 4,
                                                                      5]))
    init = [(np.asarray(w), np.asarray(b))
            for w, b in mlp_params(jax.random.PRNGKey(0), [28, 64, 64, 2])]
    lines = []
    got = downstream_task.run(args_of(
        downstream_task, "--dataset", "Syn_8", "--data_root",
        tmp_path / "t", "--epochs", 60, "--device", "cpu"), init=init,
        log=lines.append)
    np.testing.assert_array_equal(
        got["labels"], (truth[:, 1] > np.median(truth[:, 1])).astype(
            np.int32))
    np.testing.assert_array_equal(got["features"],
                                  np.delete(truth, 1, axis=1))
    assert lines[-1] in out.splitlines()


# --------------------------------------------------- dataset_statistics
def _csv_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_dataset_statistics_csvs_and_embeddings_match(tmp_path):
    from desco_tpu.data.datasets import load_data as j_load
    from desco_tpu.graph.canonical import extract_all_neighborhoods

    common = ["--datasets", "Syn_8", "--sample", 60, "--projection", "pca"]
    run_script("analysis/dataset_statistics.py", *common, "--data_root",
               tmp_path / "j", "--out", tmp_path / "jo")
    got = dataset_statistics.run(args_of(
        dataset_statistics, *common, "--data_root", tmp_path / "t", "--out",
        tmp_path / "to", "--checkpoint", NEIGH, "--device", "cpu"), **QUIET)
    for name in ("graph_stats.csv", "neighborhood_features.csv"):
        want, have = (_csv_rows(tmp_path / d / name) for d in ("jo", "to"))
        assert len(have) == len(want) > 0
        for a, b in zip(have, want):
            assert a.keys() == b.keys() and a["dataset"] == b["dataset"]
            np.testing.assert_allclose(
                [float(a[k]) for k in a if k != "dataset"],
                [float(b[k]) for k in b if k != "dataset"], rtol=1e-9)
    proj = np.load(tmp_path / "jo" / "pca_neighborhood_features.npy")
    np.testing.assert_allclose(got["neighborhood_features"]["proj"], proj,
                               rtol=0, atol=1e-5)
    assert (tmp_path / "to" / "pca_trained_embeddings.svg").exists()
    # trained embeddings of the same sampled neighborhoods
    script = runpy.run_path("analysis/dataset_statistics.py")
    neighs, _, _ = extract_all_neighborhoods(
        j_load("Syn_8", str(tmp_path / "j")), depth=4)
    idx = np.random.default_rng(0).permutation(len(neighs))[:60]
    want, labels = script["_trained_embeddings"](
        args_of(dataset_statistics, "--checkpoint", NEIGH),
        {"Syn_8": [neighs[i] for i in idx]})
    assert labels == ["Syn_8"] * 60
    np.testing.assert_allclose(got["embeddings"], want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _points(n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0, 1, (n // 2, 7)),
                        rng.normal(3, 1, (n - n // 2, 7))])
    return (x - x.mean(0)) / x.std(0)


def test_pca_matches_sklearn():
    from sklearn.decomposition import PCA

    x = _points()
    cpu = torch.device("cpu")
    np.testing.assert_allclose(dataset_statistics.pca(x, 2, cpu),
                               PCA(2, random_state=0).fit_transform(x),
                               rtol=0, atol=1e-5)
    # tiny inputs pad with zero columns, as the script's _pca2 does
    assert dataset_statistics.pca2(x[:1], cpu).shape == (1, 2)


def test_tsne_follows_sklearn():
    from sklearn.manifold import TSNE, _t_sne
    from sklearn.metrics import pairwise_distances

    x = _points()
    cpu = torch.device("cpu")
    P = dataset_statistics.joint_probabilities(x, 40, cpu).numpy()
    want = _t_sne._joint_probabilities(pairwise_distances(x, squared=True),
                                       40, 0)
    np.testing.assert_allclose(P[np.triu_indices(300, 1)], want, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(P, P.T)
    emb, kl = dataset_statistics.tsne(x, 40, cpu)
    sk = TSNE(n_components=2, perplexity=40, max_iter=300, init="pca",
              random_state=0)
    sk.fit_transform(x)
    assert emb.shape == (300, 2) and np.isfinite(emb).all()
    assert np.isfinite(kl) and kl <= 1.2 * sk.kl_divergence_
