"""The port's training loop and pipeline stages on a tiny dataset, on the
CPU: both stages train, checkpoints interchange with desco_tpu both ways,
resume continues an interrupted run exactly, and the guards (rejected
non-finite step, non-finite validation, plateau decay, val cadence) behave
as desco_tpu's (tests/test_pipeline.py)."""

import dataclasses
import json

import numpy as np
import jax
import pytest
import torch

from conftest import random_graph
from desco_tpu.graph.container import Graph as JGraph
from desco_tpu.data.workload import Workload as JWorkload
from desco_tpu.models import neighborhood as jneigh
from desco_tpu.pipeline import PipelineConfig as JConfig
from desco_tpu.pipeline import model_configs as j_model_configs
from desco_tpu.train import checkpoint as jckpt
from desco_tpu_torch import analysis as tanalysis
from desco_tpu_torch.graph import Graph
from desco_tpu_torch.models import gossip as tgossip
from desco_tpu_torch.models import neighborhood as tneigh
from desco_tpu_torch.models.shmp_gnn import dropout
from desco_tpu_torch.pipeline import (
    PipelineConfig,
    build_query_batch,
    evaluate_graphlet_counts,
    model_configs,
    neighborhood_predictions,
    prepare_gossip_batches,
    prepare_stage_data,
    train_gossip_stage,
    train_neighborhood_stage,
)
from desco_tpu_torch.train import loop as tloop
from desco_tpu_torch.train.checkpoint import (
    flatten_params, load_checkpoint, save_checkpoint)

from test_torch_shmp import jax_batch, one_torch_thread  # noqa: F401

QUIET = dict(log_fn=lambda *_: None, device="cpu")
TINY = dict(
    query_sizes=(3,), depth=3,
    neigh_layer_num=2, neigh_hidden_dim=16,
    neigh_epochs=8, neigh_batch_size=32, neigh_lr=1e-3,
    gossip_layer_num=2, gossip_hidden_dim=16,
    gossip_epochs=4, gossip_batch_size=8, gossip_lr=1e-3,
    num_workers=2)


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    return PipelineConfig(data_root=str(tmp_path_factory.mktemp("data")),
                          **TINY)


def tiny_graphs(n=16, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        g = random_graph(rng, int(rng.integers(8, 17)), 0.3)
        out.append(Graph(g.n_nodes, g.edges))
    return out


@pytest.fixture(scope="module")
def tiny_data(tiny_cfg):
    graphs = tiny_graphs()
    return tuple(
        prepare_stage_data(tiny_cfg, gs, name=name, need_truth=True)
        for gs, name in ((graphs[:10], "tiny_train"),
                         (graphs[10:13], "tiny_val"),
                         (graphs[13:], "tiny_test")))


def neigh_setup(cfg):
    tt, tq = model_configs(cfg, "cpu")
    params = tneigh.init_neighborhood_model(
        tt, tq, torch.Generator().manual_seed(0))
    return tt, tq, params, build_query_batch(cfg)


def test_groundtruth_matches_desco_tpu_and_caches(tiny_cfg, tiny_data,
                                                  tmp_path):
    train, _, _ = tiny_data
    again = train.workload.compute_groundtruth(tiny_cfg.query_ids)
    np.testing.assert_array_equal(again, train.truth)
    import os

    assert os.path.exists(train.workload.groundtruth_path(tiny_cfg.query_ids))
    jwl = JWorkload([JGraph(g.n_nodes, g.edges)
                     for g in train.workload.graphs], root=str(tmp_path))
    np.testing.assert_array_equal(
        jwl.compute_groundtruth(tiny_cfg.query_ids), train.truth)
    # the labels reached the packed batches, with the permutation
    b = train.batches[0]
    assert b.y is not None and b.edge_bwd_perm is not None
    assert float(b.y.sum()) > 0


def test_packed_to_keeps_labels_only_for_training(tiny_data):
    b = tiny_data[0].batches[0]
    served, trained = b.to("cpu"), b.to("cpu", training=True)
    assert served.y is None and served.edge_bwd_perm is None
    assert trained.y.shape == b.y.shape
    assert trained.edge_bwd_perm.dtype == torch.int32


def test_full_pipeline(tiny_cfg, tiny_data):
    train, val, test = tiny_data
    qb = build_query_batch(tiny_cfg)
    res, tgt_cfg, qry_cfg = train_neighborhood_stage(
        tiny_cfg, train, val, qb, **QUIET)
    assert res.train_losses[-1] < res.train_losses[0]
    assert np.isfinite(res.best_val)
    assert len(res.train_times) == tiny_cfg.neigh_epochs

    with torch.inference_mode():
        q_embs = tneigh.embed_queries(res.best_params, qry_cfg,
                                      qb.to("cpu"))
    counts, gbatches = {}, {}
    for name, stage in [("train", train), ("val", val), ("test", test)]:
        c, _ = neighborhood_predictions(res.best_params, tgt_cfg, q_embs,
                                        stage, tiny_cfg, "cpu")
        assert c.shape == (len(stage.samples), len(tiny_cfg.query_ids))
        counts[name] = c
        gbatches[name] = prepare_gossip_batches(
            tiny_cfg, stage, c, need_bwd_perm=name != "test")
    assert gbatches["train"][0].edge_bwd_perm is not None
    assert gbatches["test"][0].edge_bwd_perm is None
    gres, query_embs = train_gossip_stage(
        tiny_cfg, res.best_params, tgt_cfg, qry_cfg, qb,
        gbatches["train"], gbatches["val"], **QUIET)
    assert np.isfinite(gres.train_losses[-1])
    assert gres.train_losses[-1] < gres.train_losses[0]
    np.testing.assert_allclose(query_embs.numpy(), q_embs.numpy(),
                               rtol=1e-6, atol=1e-7)

    node_counts = tloop.predict_gossip_counts(gres.best_params, query_embs,
                                              gbatches["test"], "cpu")
    assert node_counts.shape == (test.workload.total_nodes,
                                 len(tiny_cfg.query_ids))
    metrics = evaluate_graphlet_counts(tiny_cfg, test, counts["test"],
                                       node_counts)
    assert set(metrics) == {"norm_mse_neighborhood", "mae_neighborhood",
                            "norm_mse_gossip", "mae_gossip"}
    for k, v in metrics.items():
        assert all(np.isfinite(x) for x in v), (k, v)


def test_analysis_matches_desco_tpu(rng):
    from desco_tpu import analysis as janalysis

    pred = rng.random((9, 6)) * 40 - 5
    truth = np.round(rng.random((9, 6)) * 40)
    groups = [[0, 1], [2, 3, 4], [5]]
    for name in ("norm_mse", "mse", "mae"):
        assert getattr(tanalysis, name)(pred, truth, groups) == \
            getattr(janalysis, name)(pred, truth, groups)
    np.testing.assert_array_equal(tanalysis.round_relu(pred),
                                  janalysis.round_relu(pred))
    assert tanalysis.norm_mse(truth[:, :1] * 0, truth[:, :1] * 0) == [0.0]


def test_checkpoint_roundtrip_both_ways(tiny_cfg, tiny_data, tmp_path):
    """desco_tpu's ``load_checkpoint`` reads what the port saved, the port
    reads what desco_tpu saved, and both predict the same counts."""
    _, _, test = tiny_data
    tt, tq, params, qb = neigh_setup(tiny_cfg)
    path = str(tmp_path / "ck")
    save_checkpoint(path, params, config=dataclasses.asdict(tiny_cfg),
                    extra={"epoch": 3})
    # port -> desco_tpu
    jcfg = JConfig(**{**TINY, "agg_mode": "aggregate_first"})
    jt, jq = j_model_configs(jcfg)
    template = jneigh.init_neighborhood_model(jax.random.PRNGKey(8), jt, jq)
    jparams, _, meta = jckpt.load_checkpoint(path, template)
    assert meta["config"]["depth"] == tiny_cfg.depth
    assert meta["extra"]["epoch"] == 3
    flat = flatten_params(params)
    for key, arr in jckpt._flatten(jparams).items():
        np.testing.assert_array_equal(arr, flat[key])
    b = test.batches[0]
    want = np.asarray(jneigh.predict_counts(jparams, jt, jq, jax_batch(b),
                                            jax_batch(qb)))
    # desco_tpu -> port
    jckpt.save_checkpoint(path + "_j", jparams,
                          config=dataclasses.asdict(jcfg))
    back, meta2 = load_checkpoint(path + "_j")
    assert meta2["config"]["neigh_hidden_dim"] == 16
    with torch.inference_mode():
        got = tneigh.predict_counts(back, tt, tq, b.to("cpu"),
                                    qb.to("cpu")).numpy()
    valid = b.graph_mask > 0
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-4,
                               atol=1e-5)


def test_nan_step_guard(tiny_cfg, tiny_data):
    """A batch with non-finite labels aborts training with a clear error,
    and the poisoned update never touched parameters or Adam moments."""
    train, val, _ = tiny_data
    tt, tq, params, qb = neigh_setup(tiny_cfg)
    before = {k: v.copy() for k, v in flatten_params(params).items()}
    bad = dataclasses.replace(
        train.batches[0], y=np.full_like(train.batches[0].y, np.nan))
    with pytest.raises(FloatingPointError, match="non-finite"):
        tloop.train_neighborhood(params, tt, tq, qb, [bad], val.batches,
                                 epochs=1, lr=1e-3, **QUIET)
    for key, arr in flatten_params(params).items():
        np.testing.assert_array_equal(arr, before[key])


def test_nonfinite_val_aborts(tiny_cfg, tiny_data):
    train, val, _ = tiny_data
    tt, tq, params, qb = neigh_setup(tiny_cfg)
    bad = dataclasses.replace(
        val.batches[0], y=np.full_like(val.batches[0].y, np.nan))
    with pytest.raises(FloatingPointError, match="validation loss"):
        tloop.train_neighborhood(params, tt, tq, qb, train.batches, [bad],
                                 epochs=2, lr=1e-3, **QUIET)


def test_val_cadence_and_best_checkpoint(tiny_cfg, tiny_data, tmp_path):
    """val_every=3 skips the val pass on other epochs (NaN in the trace)
    while best-checkpoint selection works on the evaluated ones; the last
    epoch is always evaluated."""
    train, val, _ = tiny_data
    cfg = dataclasses.replace(tiny_cfg, val_every=3, neigh_epochs=7)
    res, _, _ = train_neighborhood_stage(
        cfg, train, val, build_query_batch(cfg),
        ckpt_path=str(tmp_path / "cad"), **QUIET)
    assert [i for i, v in enumerate(res.val_losses)
            if np.isfinite(v)] == [0, 3, 6]
    assert np.isfinite(res.best_val)
    assert (tmp_path / "cad.best.params.npz").exists()
    assert (tmp_path / "cad.last.opt.npz").exists()
    best, meta = load_checkpoint(str(tmp_path / "cad.best"))
    assert meta["extra"]["val_loss"] == res.best_val
    assert meta["config"]["val_every"] == 3
    for key, arr in flatten_params(res.best_params).items():
        np.testing.assert_array_equal(arr, flatten_params(best)[key])


def test_plateau_decays_the_learning_rate(tiny_cfg, tiny_data, tmp_path):
    """With a learning rate too small to improve the monitored loss by
    the scheduler's relative threshold, patience 0 halves it after every
    epoch past the first."""
    train, val, _ = tiny_data
    tt, tq, params, qb = neigh_setup(tiny_cfg)
    lines = []
    tloop.train_neighborhood(
        params, tt, tq, qb, train.batches, val.batches, epochs=4, lr=1e-8,
        min_lr=1e-12, patience=0, ckpt_path=str(tmp_path / "pl"),
        snapshot_every=1, log_every=1, device="cpu", log_fn=lines.append)
    with open(tmp_path / "pl.last.json") as f:
        extra = json.load(f)["extra"]
    assert extra["epoch"] == 3
    assert extra["lr"] == pytest.approx(1e-8 * 0.5 ** 3)
    assert len(lines) == 4 and "edges/s" in lines[0]
    assert "lr 1.25e-09" in lines[-1]


@pytest.mark.parametrize("stage_name", ["neighborhood", "gossip"])
def test_resume_equals_uninterrupted(tiny_cfg, tiny_data, tmp_path,
                                     stage_name):
    """3 epochs, stop, resume to 6: epoch, LR, best_val, the Adam state,
    the shuffle stream and the dropout masks all continue, so the resumed
    run ends where an uninterrupted one does."""
    train, val, _ = tiny_data
    if stage_name == "neighborhood":
        cfg = dataclasses.replace(tiny_cfg, neigh_dropout=0.1)
        tt, tq, _, qb = neigh_setup(cfg)
        assert len(train.batches) > 1  # the shuffle matters

        def run(epochs, path, resume=False):
            params = tneigh.init_neighborhood_model(
                tt, tq, torch.Generator().manual_seed(0))
            return tloop.train_neighborhood(
                params, tt, tq, qb, train.batches, val.batches,
                epochs=epochs, lr=1e-3, ckpt_path=path, resume=resume,
                snapshot_every=1, patience=1, seed=4, **QUIET)
    else:
        rng = np.random.default_rng(0)
        counts = [s.truth[s.nindex.indicator]
                  * rng.uniform(0.5, 1.5, (len(s.samples), 1))
                  for s in (train, val)]
        tb, vb = (prepare_gossip_batches(tiny_cfg, s, c, need_bwd_perm=True)
                  for s, c in zip((train, val), counts))
        q_embs = torch.from_numpy(
            rng.standard_normal((1, 16)).astype(np.float32))
        assert len(tb) > 1

        def run(epochs, path, resume=False):
            params = tgossip.init_gossip_model(
                hidden_dim=16, emb_channels=16,
                generator=torch.Generator().manual_seed(1))
            return tloop.train_gossip(
                params, q_embs, tb, vb, epochs=epochs, lr=1e-3,
                dropout=0.1, ckpt_path=path, resume=resume,
                snapshot_every=1, patience=1, seed=4, **QUIET)

    whole = run(6, str(tmp_path / "whole"))
    run(3, str(tmp_path / "parts"))
    resumed = run(6, str(tmp_path / "parts"), resume=True)
    assert len(resumed.train_losses) == 3  # epochs 3, 4, 5 only
    np.testing.assert_allclose(resumed.train_losses, whole.train_losses[3:],
                               rtol=1e-6)
    np.testing.assert_allclose(resumed.val_losses, whole.val_losses[3:],
                               rtol=1e-6)
    assert resumed.best_val == pytest.approx(whole.best_val, rel=1e-6)
    for key, arr in flatten_params(whole.params).items():
        np.testing.assert_allclose(flatten_params(resumed.params)[key], arr,
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    with open(tmp_path / "parts.last.json") as f, \
            open(tmp_path / "whole.last.json") as g:
        a, b = json.load(f)["extra"], json.load(g)["extra"]
    assert a["epoch"] == b["epoch"] == 5
    assert a["lr"] == b["lr"] and a["num_bad"] == b["num_bad"]


def test_checkpointed_gossip_loss_redraws_its_dropout_masks(tiny_cfg,
                                                            tiny_data,
                                                            monkeypatch):
    """The per-query recomputation under torch.utils.checkpoint must see
    the masks of the first pass: gradients equal those of the same loss
    without checkpointing, and the generator ends where the forward left
    it once the step has put it back."""
    train = tiny_data[0]
    rng = np.random.default_rng(3)
    counts = train.truth[train.nindex.indicator] + 1.0
    (gb,) = prepare_gossip_batches(
        dataclasses.replace(tiny_cfg, gossip_batch_size=64), train, counts,
        need_bwd_perm=True)
    b = gb.to("cpu", training=True)
    q_embs = torch.from_numpy(
        rng.standard_normal((b.node_y.shape[1], 16)).astype(np.float32))

    def grads(use_checkpoint):
        if not use_checkpoint:
            monkeypatch.setattr(tgossip, "checkpoint",
                                lambda fn, *a, **kw: fn(*a))
        params = tgossip.init_gossip_model(
            hidden_dim=16, emb_channels=16,
            generator=torch.Generator().manual_seed(1))
        gen = torch.Generator().manual_seed(11)
        opt = tloop.make_adam(params)
        loss, _ = tloop.train_step(
            params, opt, tloop.gossip_loss_fn(0.5, q_embs), b, 0.0, gen)
        return float(loss), opt.grad.clone(), gen.get_state()

    l1, g1, s1 = grads(True)
    l2, g2, s2 = grads(False)
    assert l1 == l2 and torch.equal(s1, s2)
    assert float(g1.abs().max()) > 0
    torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-7)


def test_dropout_keeps_one_minus_rate_and_rescales():
    x = torch.ones(200, 100)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.25, True, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert dropout(x, 0.25, False, gen) is x   # not training
    assert dropout(x, 0.25, True, None) is x   # no generator: validation
    assert dropout(x, 0.0, True, gen) is x


def test_unported_training_options_raise(tiny_cfg, tiny_data):
    train, val, _ = tiny_data
    qb = build_query_batch(tiny_cfg)
    with pytest.raises(NotImplementedError, match="M12"):
        train_neighborhood_stage(
            dataclasses.replace(tiny_cfg, train_bf16=True), train, val, qb,
            **QUIET)
    with pytest.raises(NotImplementedError, match="M15"):
        train_neighborhood_stage(tiny_cfg, train, val, qb, mesh=object(),
                                 **QUIET)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_gossip_stage(tiny_cfg, None, None, None, qb, [], [],
                           mesh=object(), **QUIET)
    if not torch.cuda.is_available():  # the default device is the GPU
        with pytest.raises(RuntimeError, match="CUDA"):
            train_neighborhood_stage(tiny_cfg, train, val, qb,
                                     log_fn=lambda *_: None)
