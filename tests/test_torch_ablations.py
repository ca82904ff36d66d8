"""desco_tpu_torch's ablation path against desco_tpu: order-4 (orbit)
typing, the homogeneous samples, the whole-graph samples of the
no-canonical ablation, the order-4 and homogeneous target towers, both
ablation drivers and serving a GIN checkpoint.

Host arrays (orbit counts, types, samples, packed batches) must be
equal. Towers: desco_tpu's weights carried over with ``params_from_jax``,
dropout 0, float32 on both sides: values rtol 1e-4 / atol 1e-5, gradients
rtol 1e-4 with atol 1e-6 of each tensor's scale (tests/test_torch_grad.py;
only the summation order differs). Serving: neighborhood counts rtol 1e-3
(floored at 1e-2), verified rows equal, graphlet counts within 1
(tests/test_torch_serving.py). Graphs are small (5-13 nodes, depth 2),
towers narrow (2 layers, width 16)."""

import dataclasses
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import random_graph
from desco_tpu.batch.packed import auto_capacities as j_auto_capacities
from desco_tpu.batch.packed import pack_samples as j_pack_samples
from desco_tpu.data.workload import Workload as JWorkload
from desco_tpu.graph import orbits as jorb
from desco_tpu.graph.atlas import gen_query_ids
from desco_tpu.models import neighborhood as jneigh
from desco_tpu.models import shmp_gnn as jshmp
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch import ablation_gnns, ablation_wo_canonical
from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
from desco_tpu_torch.data.workload import Workload
from desco_tpu_torch.graph import Graph
from desco_tpu_torch.graph import orbits as torb
from desco_tpu_torch.models import shmp_gnn as tshmp
from desco_tpu_torch.train.checkpoint import params_from_jax

from test_torch_grad import assert_grads_match
from test_torch_shmp import jax_batch, one_torch_thread  # noqa: F401

QIDS = gen_query_ids([3, 4])
SAMPLE_FIELDS = ("node_type", "x", "edge_src", "edge_dst", "edge_type", "y")


def graph_pair(seed, n_graphs=5, sizes=(5, 13), p=0.4):
    """The same random graphs as desco_tpu's and as the port's Graph."""
    rng = np.random.default_rng(seed)
    jg = [random_graph(rng, int(rng.integers(*sizes)), p)
          for _ in range(n_graphs)]
    return jg, [Graph(g.n_nodes, g.edges.copy()) for g in jg]


def assert_same_samples(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        for f in SAMPLE_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)), f)


# ------------------------------------------------------------------ host
@pytest.mark.parametrize("seed", range(3))
def test_orbit_counts_and_types_equal_desco_tpu(seed):
    rng = np.random.default_rng(seed)
    for n, p in ((4, 0.6), (7, 0.5), (10, 0.4), (13, 0.3), (9, 0.9)):
        g = random_graph(rng, n, p)
        tg = Graph(g.n_nodes, g.edges.copy())
        np.testing.assert_array_equal(torb.edge_orbit_counts(tg),
                                      jorb.edge_orbit_counts(g))
        np.testing.assert_array_equal(torb.order4_edge_types(tg),
                                      jorb.order4_edge_types(g))


@pytest.mark.parametrize("kind", ["order4", "homogeneous"])
def test_samples_and_batches_equal_desco_tpu(kind, tmp_path):
    """Order-4 and homogeneous samples field by field, their packed
    batches, and the sample cache under desco_tpu's name (``_order4``,
    ``_homo``), which desco_tpu reads back."""
    jg, tg = graph_pair(1)
    kw = (dict(order=4) if kind == "order4"
          else dict(use_hetero=False, use_tconv=False))
    total = sum(g.n_nodes for g in tg)
    truth = np.random.default_rng(2).integers(0, 9, (total, len(QIDS)))
    jw = JWorkload(jg, root=str(tmp_path / "j"))
    js, jidx = jw.neighborhood_samples(2, QIDS, truth=truth,
                                       use_cache=False, **kw)
    tw = Workload(tg, root=str(tmp_path / "t"))
    ts, tidx = tw.neighborhood_samples(2, truth=truth, use_cache=True, **kw)
    assert_same_samples(ts, js)
    np.testing.assert_array_equal(tidx.index, jidx.index)
    np.testing.assert_array_equal(tidx.indicator, jidx.indicator)
    types = np.concatenate([s.edge_type for s in ts])
    if kind == "order4":
        assert types.max() < 33 and len(np.unique(types)) >= 9
        assert tw.typing_seconds is not None
    else:
        assert not types.any()
        assert all(s.x[s.node_type == 1].min() == 1.0 for s in ts)
    caps = auto_capacities(ts, g_cap=16)
    assert caps == j_auto_capacities(js, g_cap=16)
    for a, b in zip(pack_samples(ts, *caps, n_queries=len(QIDS)),
                    j_pack_samples(js, *caps, n_queries=len(QIDS))):
        for f, v in a.fields():
            np.testing.assert_array_equal(v, np.asarray(getattr(b, f)), f)
    # the port's cache under desco_tpu's name, read back by desco_tpu
    jcache = JWorkload(jg, root=str(tmp_path / "t"))
    path = jcache._neigh_cache_path(2, kw.get("use_tconv", True),
                                    kw.get("use_hetero", True), False,
                                    kw.get("order", 3))
    assert os.path.isdir(path)
    assert_same_samples(jcache.neighborhood_samples(
        2, QIDS, truth=truth, use_cache=True, **kw)[0], js)


def test_wo_canonical_samples_equal_desco_tpu(tmp_path):
    """Whole-graph samples with raw graphlet counts as labels (no log),
    truth by VF2 on both sides."""
    jg, tg = graph_pair(3, n_graphs=4)
    for tconv in (True, False):
        js = JWorkload(jg, root=str(tmp_path)).wo_canonical_samples(
            QIDS, use_tconv=tconv)
        ts = Workload(tg).wo_canonical_samples(QIDS, use_tconv=tconv)
        assert_same_samples(ts, js)
        assert max(float(s.y.max()) for s in ts) > 1.0  # raw counts


# ---------------------------------------------------------------- towers
def typed_batch(kind, seed=0):
    jg, tg = graph_pair(seed, n_graphs=6)
    kw = (dict(order=4) if kind == "order4"
          else dict(use_hetero=False, use_tconv=False))
    samples, _ = Workload(tg).neighborhood_samples(2, **kw)
    rng = np.random.default_rng(seed)
    if kind == "order4":  # random inputs exercise the pre-linear fully
        for s in samples:
            s.x = rng.standard_normal((s.n_nodes, 1)).astype(np.float32)
    (b,) = pack_samples(samples, *auto_capacities(samples, g_cap=64))
    return b


@pytest.mark.parametrize("kind,conv,agg_mode", [
    ("order4", "SAGE", "aggregate_first"), ("order4", "SAGE", "kernel"),
    ("order4", "GIN", "kernel"), ("homogeneous", "SAGE", "kernel"),
    ("homogeneous", "GCN", "aggregate_first")])
def test_ablation_towers_match_desco_tpu(kind, conv, agg_mode):
    """neighborhood_target_config(order=4) (33 edge types) and
    (use_hetero=False) against desco_tpu: values and the gradients of
    every parameter (K2 / K3's plain versions in the kernel mode)."""
    kw = dict(input_dim=1, hidden_dim=16, output_dim=16, layer_num=2,
              conv_type=conv,
              **(dict(order=4) if kind == "order4"
                 else dict(use_hetero=False, use_tconv=False)))
    jcfg = jshmp.neighborhood_target_config(**kw)
    tcfg = tshmp.neighborhood_target_config(agg_mode=agg_mode, **kw)
    assert tcfg == dataclasses.replace(
        tcfg, n_edge_types=jcfg.n_edge_types, n_node_types=jcfg.n_node_types,
        edge_dst_type=tuple(jcfg.edge_dst_type))
    assert tcfg.n_edge_types == (33 if kind == "order4" else 1)
    jparams = jshmp.init_shmp(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(_flatten(jparams))
    batch = typed_batch(kind)
    jb = jax_batch(batch)
    ref = np.asarray(jshmp.apply_shmp(jparams, jcfg, jb))
    with torch.inference_mode():
        out = tshmp.apply_shmp(tparams, tcfg, batch.to("cpu")).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    cot = np.random.default_rng(7).standard_normal(ref.shape).astype(
        np.float32)
    jgrads = jax.grad(lambda p: (jshmp.apply_shmp(p, jcfg, jb)
                                 * jnp.asarray(cot)).sum())(jparams)
    tparams.requires_grad_(True)
    (tshmp.apply_shmp(tparams, tcfg, batch.to("cpu", training=True))
     * torch.from_numpy(cot)).sum().backward()
    assert_grads_match(tparams, jgrads, min_nonzero=5)


# --------------------------------------------------------------- drivers
TINY = ["--device", "cpu", "--neigh_layer_num", "2", "--neigh_hidden_dim",
        "16", "--gossip_hidden_dim", "16", "--neigh_epoch_num", "1",
        "--gossip_epoch_num", "1", "--query_sizes", "3", "4",
        "--num_cpu", "2"]


def _paths(tmp_path):
    return ["--data_root", str(tmp_path / "d"), "--output_dir",
            str(tmp_path / "o"), "--neigh_model_path", str(tmp_path / "n"),
            "--gossip_model_path", str(tmp_path / "g")]


def _figures(text, key):
    (line,) = [ln for ln in text.splitlines() if ln.startswith(key)]
    vals = [float(v) for v in re.findall(r"[-+0-9.e]+", line.split(":")[1])]
    assert len(vals) == 2 and np.isfinite(vals).all(), line
    return vals


def test_ablation_gnns_runs_one_epoch_on_the_cpu(tmp_path, capsys):
    rc = ablation_gnns.main(TINY + _paths(tmp_path) + [
        "--train_neigh", "--train_gossip", "--test_gossip",
        "--train_dataset", "SynNp_6", "--valid_dataset", "SynNp_6",
        "--test_dataset", "SynNp_3_1", "--neigh_conv_type", "GIN"])
    out = capsys.readouterr().out
    assert rc == 0 and "(device cpu)" in out
    _figures(out, "graphlet_norm_mse_neighborhood")
    _figures(out, "graphlet_norm_mse_gossip")
    with open(str(tmp_path / "n") + ".best.json") as f:
        saved = f.read()
    assert '"use_hetero": false' in saved and '"conv_type": "GIN"' in saved


def test_ablation_wo_canonical_runs_one_epoch_on_the_cpu(tmp_path, capsys):
    rc = ablation_wo_canonical.main(TINY + _paths(tmp_path) + [
        "--train_dataset", "SynNp_12", "--valid_dataset", "SynNp_12",
        "--test_dataset", "SynNp_4_1", "--neigh_conv_type", "PNA"])
    out = capsys.readouterr().out
    assert rc == 0 and "(device cpu)" in out
    _figures(out, "wo_canonical graphlet_norm_mse")
    _figures(out, "wo_canonical graphlet_mae")


# --------------------------------------------------------------- serving
def test_gin_checkpoint_serves_like_desco_tpu(tmp_path):
    """A GIN neighborhood checkpoint written by desco_tpu's
    save_checkpoint: both CountingServices rehydrate conv_type from its
    config blob and count the same graphs alike."""
    from desco_tpu.pipeline import PipelineConfig as JConfig
    from desco_tpu.pipeline import model_configs as j_model_configs
    from desco_tpu.serving import CountingService as JService
    from desco_tpu.train.checkpoint import save_checkpoint
    from desco_tpu_torch.serving import CountingService

    cfg = JConfig(conv_type="GIN", neigh_layer_num=2, neigh_hidden_dim=16,
                  query_sizes=(3, 4), depth=2,
                  agg_mode="aggregate_first")
    jt, jq = j_model_configs(cfg)
    jparams = jneigh.init_neighborhood_model(jax.random.PRNGKey(3), jt, jq)
    path = str(tmp_path / "gin")
    save_checkpoint(path, jparams, config=dataclasses.asdict(cfg))
    jg, tg = graph_pair(4, n_graphs=5)
    ref = JService(path).count(jg)
    svc = CountingService(path, device="cpu")
    assert svc.tgt_cfg.conv_type == svc.qry_cfg.conv_type == "GIN"
    ours = svc.count(tg)
    np.testing.assert_allclose(ours.neighborhood_counts,
                               ref.neighborhood_counts, rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_array_equal(ours.verified_rows, ref.verified_rows)
    assert np.abs(ours.graphlet_counts - ref.graphlet_counts).max() <= 1


def test_degree_feature_without_hetero_is_refused_as_in_desco_tpu():
    """Both packages refuse it: the degree would overwrite column 0 of x,
    the homogeneous samples' canonical indicator."""
    from desco_tpu.pipeline import PipelineConfig as JConfig
    from desco_tpu.pipeline import _check_degree_feature_combo
    from desco_tpu_torch.pipeline import PipelineConfig, model_configs

    with pytest.raises(ValueError, match="use_hetero"):
        _check_degree_feature_combo(JConfig(degree_feature=True,
                                            use_hetero=False))
    with pytest.raises(ValueError, match="use_hetero"):
        model_configs(PipelineConfig(degree_feature=True, use_hetero=False),
                      "cpu")
