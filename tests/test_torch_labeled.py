"""desco_tpu_torch's labeled mode (``use_node_feature``) against
desco_tpu's: query label expansion, labeled VF2 truth and its cache,
featured neighborhood samples (both sample builders), label-preserving
bounds, labeled tail verification and exact columns, a labeled
``CountingService`` and a labeled train step. Mirrors
tests/test_node_features.py.

Host results (queries, truth, samples, packed batches, bounds, verified
rows) must be equal. Serving: counts rtol 1e-3 (floored at 1e-2, as in
tests/test_torch_serving.py), verified rows equal, graphlet counts within
1. Gradients: rtol 1e-4 with atol 1e-6 of each tensor's scale
(tests/test_torch_grad.py). Graphs are small (6-12 nodes, depth 2) with 2
labels drawn from a seeded numpy generator; towers 2 layers, width 16."""

import dataclasses

import numpy as np
import jax
import pytest

from conftest import random_graph
from desco_tpu.batch.packed import auto_capacities as j_auto_capacities
from desco_tpu.batch.packed import pack_samples as j_pack_samples
from desco_tpu.data.workload import Workload as JWorkload
from desco_tpu.graph.atlas import expand_query_labels as j_expand
from desco_tpu.graph.atlas import gen_queries as j_gen_queries
from desco_tpu.models import neighborhood as jneigh
from desco_tpu.pipeline import PipelineConfig as JConfig
from desco_tpu.pipeline import model_configs as j_model_configs
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch import pipeline as tpipe
from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
from desco_tpu_torch.data.workload import Workload
from desco_tpu_torch.graph import Graph, gen_queries, gen_query_ids
from desco_tpu_torch.graph.atlas import expand_query_labels
from desco_tpu_torch.models import neighborhood as tneigh
from desco_tpu_torch.truth import native as truth_native
from desco_tpu_torch.truth.bounds import neighborhood_count_bounds
from desco_tpu_torch.truth.vf2 import count_induced_embeddings, symmetric_factor
from desco_tpu_torch.train.checkpoint import params_from_jax

from test_torch_ablations import assert_same_samples
from test_torch_grad import assert_grads_match
from test_torch_shmp import jax_batch, one_torch_thread  # noqa: F401

N_LABELS = 2
CFG = dict(query_sizes=(3,), depth=2, neigh_layer_num=2, neigh_hidden_dim=16,
           gossip_hidden_dim=16, neigh_input_dim=N_LABELS,
           use_node_feature=True, agg_mode="aggregate_first")


def labeled_pair(seed, n_graphs=5, sizes=(6, 12), p=0.4):
    """The same random graphs with the same one-hot labels, as desco_tpu's
    and as the port's Graph."""
    rng = np.random.default_rng(seed)
    jg = []
    for _ in range(n_graphs):
        g = random_graph(rng, int(rng.integers(*sizes)), p)
        g.node_feat = np.eye(N_LABELS, dtype=np.float32)[
            rng.integers(0, N_LABELS, g.n_nodes)]
        jg.append(g)
    return jg, [Graph(g.n_nodes, g.edges.copy(), g.node_feat.copy())
                for g in jg]


def labeled_queries(sizes=(3,)):
    qids = gen_query_ids(list(sizes))
    return ([v for q in j_gen_queries(qids) for v in j_expand(q, N_LABELS)],
            [v for q in gen_queries(qids)
             for v in expand_query_labels(q, N_LABELS)])


# ------------------------------------------------------------- queries
@pytest.mark.parametrize("n_labels", [2, 3])
def test_expand_query_labels_equals_desco_tpu(n_labels):
    qids = gen_query_ids([3, 4])
    for jq, tq in zip(j_gen_queries(qids), gen_queries(qids)):
        mine, theirs = expand_query_labels(tq, n_labels), j_expand(
            jq, n_labels)
        assert len(mine) == len(theirs) == n_labels ** tq.n_nodes
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a.edges, b.edges)
            np.testing.assert_array_equal(a.node_feat, b.node_feat)
            assert a.node_feat.dtype == np.float32


def test_pipeline_queries_expand_as_desco_tpu():
    """The expanded set at the paper's sizes: 2^3 x 2 + 2^4 x 6 + 2^5 x 21
    = 784 queries, in desco_tpu's order, grouped by size alike."""
    from desco_tpu.pipeline import pipeline_queries as j_pipeline_queries
    from desco_tpu.pipeline import pipeline_query_groups as j_groups

    kw = dict(use_node_feature=True, neigh_input_dim=2)
    mine = tpipe.pipeline_queries(tpipe.PipelineConfig(**kw))
    theirs = j_pipeline_queries(JConfig(**kw))
    assert len(mine) == len(theirs) == 784
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.edges, b.edges)
        np.testing.assert_array_equal(a.node_feat, b.node_feat)
    assert tpipe.pipeline_query_groups(tpipe.PipelineConfig(**kw)) == \
        j_groups(JConfig(**kw))
    assert len(tpipe.pipeline_queries(tpipe.PipelineConfig())) == 29


def test_labeled_symmetric_factor():
    tri = Graph(3, np.array([[0, 1], [1, 2], [0, 2]]))
    assert symmetric_factor(tri, np.array([0, 0, 0])) == 6
    assert symmetric_factor(tri, np.array([0, 0, 1])) == 2
    assert symmetric_factor(tri, np.array([0, 1, 2])) == 1


@pytest.mark.parametrize("seed", range(3))
def test_labeled_counts_sum_to_unlabeled_native_and_python(seed):
    """Summed over a query's label assignments, labeled counts give the
    unlabeled count; the native VF2 with labels equals its Python twin
    node by node."""
    rng = np.random.default_rng(seed)
    g = random_graph(rng, 11, 0.35)
    g = Graph(g.n_nodes, g.edges.copy())
    labels = rng.integers(0, 2, g.n_nodes).astype(np.int32)
    for q in gen_queries(gen_query_ids([3, 4])):
        total = 0
        for v in expand_query_labels(q, 2):
            ql = truth_native.labels_of(v)
            per_py = np.zeros(g.n_nodes, np.int64)
            total += count_induced_embeddings(g, q, per_py, labels, ql)
            per_c = np.zeros(g.n_nodes, np.int64)
            assert truth_native.vf2_count_native(
                g, q, per_c, labels, ql) == per_py.sum()
            np.testing.assert_array_equal(per_c, per_py)
        assert total == count_induced_embeddings(g, q)
    with pytest.raises(ValueError, match="together"):
        truth_native.vf2_count_native(g, q, None, labels, None)


# --------------------------------------------------------------- truth
@pytest.mark.parametrize("seed", range(2))
def test_labeled_truth_equals_desco_tpu(seed, tmp_path):
    """Truth exactly, under the same cache file name (either package
    reads the other's), and desco_tpu's invariant: raw labeled counts
    summed over a query's variants are the raw unlabeled count."""
    jg, tg = labeled_pair(seed)
    jqs, tqs = labeled_queries((3, 4))
    jw = JWorkload(jg, root=str(tmp_path / "j"), name="lab")
    tw = Workload(tg, root=str(tmp_path / "t"), name="lab")
    want = jw.compute_groundtruth_labeled(jqs)
    got = tw.compute_groundtruth_labeled(tqs)
    np.testing.assert_array_equal(got, want)
    jfiles = sorted(p.name for p in (tmp_path / "j").rglob("*.npy"))
    tfiles = sorted(p.name for p in (tmp_path / "t").rglob("*.npy"))
    assert jfiles == tfiles and len(tfiles) == 1
    np.testing.assert_array_equal(tw.compute_groundtruth_labeled(tqs), got)
    # the port reads desco_tpu's cache
    tj = Workload(tg, root=str(tmp_path / "j"), name="lab")
    np.testing.assert_array_equal(tj.compute_groundtruth_labeled(tqs), want)
    unl = tw.compute_groundtruth(gen_query_ids([3, 4]), use_cache=False)
    sf_v = np.array([symmetric_factor(v, truth_native.labels_of(v))
                     for v in tqs], np.float64)
    base = gen_queries(gen_query_ids([3, 4]))
    sf_b = np.array([symmetric_factor(q) for q in base], np.float64)
    owner = np.repeat(np.arange(len(base)),
                      [N_LABELS ** q.n_nodes for q in base])
    raw = np.stack([(got * sf_v)[:, owner == b].sum(1)
                    for b in range(len(base))], 1)
    np.testing.assert_allclose(raw, unl * sf_b)


# ------------------------------------------------------------- samples
@pytest.mark.parametrize("native", [True, False], ids=["native", "generic"])
def test_featured_samples_equal_desco_tpu(native, tmp_path, monkeypatch):
    """Featured samples field by field (x is each node's one-hot label),
    their packed batches, and the sample cache's ``_node_feat`` name; the
    generic builder (order-3 samples without the native library) gives
    the same samples as the native one."""
    jg, tg = labeled_pair(7)
    jqs, tqs = labeled_queries()
    jw = JWorkload(jg, root=str(tmp_path / "j"), name="lab")
    truth = jw.compute_groundtruth_labeled(jqs)
    if not native:
        monkeypatch.setattr(truth_native, "native_available", lambda: False)
    tw = Workload(tg, root=str(tmp_path / "t"), name="lab")
    js, jidx = jw.neighborhood_samples(2, gen_query_ids([3]), truth=truth,
                                       use_node_feat=True)
    ts, tidx = tw.neighborhood_samples(2, truth=truth, use_cache=True,
                                       use_node_feat=True)
    np.testing.assert_array_equal(tidx.index, jidx.index)
    if native:
        assert_same_samples(ts, js)
    else:  # the same samples up to the order of each sample's edges
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.x, b.x)
            np.testing.assert_array_equal(a.node_type, b.node_type)
            ka = sorted(zip(a.edge_src, a.edge_dst, a.edge_type))
            kb = sorted(zip(b.edge_src, b.edge_dst, b.edge_type))
            assert ka == kb
    assert ts[0].x.shape[1] == N_LABELS
    np.testing.assert_array_equal(
        np.concatenate([s.x for s in ts]).sum(1), 1.0)
    assert (tmp_path / "t" / "NeighborhoodDataset" /
            "neighs_depth_2_tconv_node_feat").is_dir()
    assert (tmp_path / "j" / "NeighborhoodDataset" /
            "neighs_depth_2_tconv_node_feat").is_dir()
    caps = auto_capacities(ts, g_cap=64)
    (tb,) = pack_samples(ts, *caps, n_queries=len(tqs))
    (jb,) = j_pack_samples(js, *j_auto_capacities(js, g_cap=64),
                           n_queries=len(jqs))
    if native:
        for f in ("x", "node_type", "edge_src", "edge_dst", "edge_type", "y"):
            np.testing.assert_array_equal(np.asarray(getattr(tb, f)),
                                          np.asarray(getattr(jb, f)), f)
    with pytest.raises(ValueError, match="use_hetero"):
        tw.neighborhood_samples(2, use_node_feat=True, use_hetero=False)


def test_labeled_stage_data_and_bounds_equal_desco_tpu(tmp_path):
    """``prepare_stage_data`` in labeled mode: truth, samples and batches
    as desco_tpu's; the label-preserving bounds equal, and above the
    structural ones."""
    from desco_tpu.pipeline import prepare_stage_data as j_prepare
    from desco_tpu.pipeline import stage_bounds as j_stage_bounds

    jg, tg = labeled_pair(11, n_graphs=6)
    jcfg = JConfig(data_root=str(tmp_path / "j"), **CFG)
    tcfg = tpipe.PipelineConfig(data_root=str(tmp_path / "t"), **CFG)
    js = j_prepare(jcfg, jg, "lab")
    ts = tpipe.prepare_stage_data(tcfg, tg, name="lab", need_truth=True)
    np.testing.assert_array_equal(ts.truth, js.truth)
    assert ts.truth.shape[1] == 16
    assert_same_samples(ts.samples, js.samples)
    assert len(ts.batches) == len(js.batches)
    for a, b in zip(ts.batches, js.batches):
        for f in ("x", "edge_src", "edge_type", "y"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)))
    want = j_stage_bounds(js, jcfg)
    got = tpipe.stage_bounds(ts, tcfg, device="cpu")
    np.testing.assert_array_equal(got, want)
    structural = neighborhood_count_bounds(
        ts.batches, tpipe.pipeline_queries(tcfg), device="cpu")
    assert (got >= structural).all() and (got > structural).any()
    # every truth row sits under its bound
    assert (ts.truth[ts.nindex.indicator] <= got + 1e-6).all()
    # serving (no truth) packs the same batches with zero labels
    srv = tpipe.prepare_stage_data(tcfg, tg)
    assert srv.truth.shape == ts.truth.shape and not srv.truth.any()
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpipe.prepare_stage_data(
            dataclasses.replace(tcfg, degree_feature=True), tg)


@pytest.mark.parametrize("what", ["verify_tail", "exact_small"])
def test_labeled_exact_paths_equal_desco_tpu(what, tmp_path):
    """Labeled tail verification and labeled exact columns recount the
    same rows to the same values from the same predicted counts."""
    from desco_tpu import pipeline as jpipe

    jg, tg = labeled_pair(3, n_graphs=6)
    jcfg = JConfig(data_root=str(tmp_path), verify_budget=0.2,
                   exact_size=3, **CFG)
    tcfg = tpipe.PipelineConfig(data_root=str(tmp_path), verify_budget=0.2,
                                exact_size=3, **CFG)
    js = jpipe.prepare_stage_data(jcfg, jg, "lab", need_truth=False)
    ts = tpipe.prepare_stage_data(tcfg, tg)
    rng = np.random.default_rng(0)
    counts = rng.uniform(0, 50, (len(ts.samples), 16))
    if what == "verify_tail":
        got, rows = tpipe.verify_tail_counts(counts, ts, tcfg)
        want, jrows = jpipe.verify_tail_counts(counts, js, jcfg)
        np.testing.assert_array_equal(rows, jrows)
        assert len(rows) > 0
    else:
        got, cols = tpipe.exact_small_counts(counts, ts, tcfg)
        want, jcols = jpipe.exact_small_counts(counts, js, jcfg)
        np.testing.assert_array_equal(cols, jcols)
        rows = np.arange(len(ts.samples))
    np.testing.assert_array_equal(got, want)
    # the recounted rows are the labeled truth
    truth = Workload(tg).compute_groundtruth_labeled(
        tpipe.pipeline_queries(tcfg), use_cache=False)[ts.nindex.indicator]
    np.testing.assert_array_equal(got[rows], truth[rows])


# ------------------------------------------------------- service, train
def labeled_checkpoints(tmp_path, seed=3):
    """A labeled neighborhood model and a gossip model written by
    desco_tpu's save_checkpoint."""
    from desco_tpu.models.gossip import init_gossip_model
    from desco_tpu.train.checkpoint import save_checkpoint

    cfg = JConfig(**CFG)
    jt, jq = j_model_configs(cfg)
    jparams = jneigh.init_neighborhood_model(jax.random.PRNGKey(seed), jt, jq)
    npath, gpath = str(tmp_path / "lab_neigh"), str(tmp_path / "lab_gossip")
    save_checkpoint(npath, jparams, config=dataclasses.asdict(cfg))
    gp = init_gossip_model(jax.random.PRNGKey(seed + 1), input_dim=1,
                           hidden_dim=16, emb_channels=16, layer_num=2)
    save_checkpoint(gpath, gp, config=dataclasses.asdict(cfg))
    return npath, gpath


def test_labeled_service_matches_desco_tpu(tmp_path):
    """A labeled checkpoint served by both CountingServices on graphs
    with one-hot node_feat: the config (labels, the 16 expanded size-3
    queries) rehydrates, counts agree, verified rows are equal."""
    from desco_tpu.serving import CountingService as JService
    from desco_tpu_torch.serving import CountingService

    npath, gpath = labeled_checkpoints(tmp_path)
    jg, tg = labeled_pair(5, n_graphs=6)
    over = {"verify_budget": 0.05}
    ref = JService(npath, gpath, config_overrides=over).count(jg)
    svc = CountingService(npath, gpath, device="cpu", config_overrides=over)
    assert svc.cfg.use_node_feature and svc.tgt_cfg.input_dim == N_LABELS
    assert tuple(svc.member_embs[0].shape) == (16, 16)
    ours = svc.count(tg)
    assert ours.refined and ours.graphlet_counts.shape == (6, 16)
    np.testing.assert_allclose(ours.neighborhood_counts,
                               ref.neighborhood_counts, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(ours.node_counts, ref.node_counts,
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_array_equal(ours.verified_rows, ref.verified_rows)
    assert len(ours.verified_rows) > 0
    rows = ours.verified_rows
    np.testing.assert_array_equal(ours.neighborhood_counts[rows],
                                  ref.neighborhood_counts[rows])
    assert np.abs(ours.graphlet_counts - ref.graphlet_counts).max() <= 1


def test_labeled_train_step_matches_desco_tpu(tmp_path):
    """Loss and every parameter's gradient of one labeled train step on
    a featured batch with labeled truth."""
    jg, tg = labeled_pair(9, n_graphs=6)
    tcfg = tpipe.PipelineConfig(data_root=str(tmp_path), **CFG)
    st = tpipe.prepare_stage_data(tcfg, tg, name="lab", need_truth=True)
    qb = tpipe.build_query_batch(tcfg)
    assert qb.x.shape[1] == N_LABELS and qb.g_cap >= 16
    jt, jq = j_model_configs(JConfig(**CFG))
    jparams = jneigh.init_neighborhood_model(jax.random.PRNGKey(1), jt, jq)
    tparams = params_from_jax(_flatten(jparams))
    tt, tq = tpipe.model_configs(tcfg, "cpu")
    tb = st.batches[0]
    want, jgrads = jax.value_and_grad(jneigh.train_loss)(
        jparams, jt, jq, jax_batch(tb), jax_batch(qb))
    loss = tneigh.train_loss(tparams, tt, tq, tb.to("cpu", training=True),
                             qb.to("cpu"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert_grads_match(tparams, jgrads, min_nonzero=10)


def test_labeled_flags_reach_the_pipeline():
    from desco_tpu_torch.config import build_parser, to_pipeline_config

    cfg = to_pipeline_config(build_parser().parse_args(
        ["--use_node_feature", "--neigh_input_dim", "2"]))
    assert cfg.use_node_feature and cfg.neigh_input_dim == 2
    tgt, qry = tpipe.model_configs(cfg, "cpu")
    assert tgt.input_dim == qry.input_dim == 2
    assert len(tpipe.pipeline_queries(cfg)) == 784
