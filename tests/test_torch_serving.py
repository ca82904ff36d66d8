"""desco_tpu_torch serving against desco_tpu's CountingService on the
release/r4 checkpoints (SAGE SHMP, 8 layers, hidden 64; 2-layer gossip),
on the CPU.

Tolerances: neighborhood and node counts rtol 1e-3 of the count (floored
at 1e-2 absolute: a de-logged 2^pred - 1 near zero carries pred's f32
rounding, not a count); verified rows are exact VF2 counts on both sides
and must be equal; graphlet counts are rounded sums and may differ by at
most 1 where a sum sits at a rounding boundary."""

import io
import json

import numpy as np
import pytest
import torch

from desco_tpu.data.synthetic import generate_synthetic
from desco_tpu_torch.graph import Graph
from desco_tpu_torch.serving import CountingService
from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)

NEIGH, GOSSIP = "release/r4/neigh.best", "release/r4/gossip.best"


@pytest.fixture(scope="module")
def graphs():
    jgraphs = generate_synthetic(6, min_size=10, max_size=28, seed=5)
    return jgraphs, [Graph(g.n_nodes, g.edges.copy()) for g in jgraphs]


@pytest.fixture(scope="module")
def port_service():
    return CountingService(NEIGH, GOSSIP, device="cpu")


@pytest.fixture(scope="module")
def results(graphs, port_service):
    from desco_tpu.serving import CountingService as JService

    jgraphs, tgraphs = graphs
    ref = JService(NEIGH, GOSSIP).count(jgraphs)
    return port_service.count(tgraphs), ref


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-2)


def test_r4_service_matches_desco_tpu(results, graphs):
    ours, ref = results
    assert ours.refined and ref.refined
    assert ours.graphlet_counts.shape == (len(graphs[1]), 29)
    _close(ours.neighborhood_counts, ref.neighborhood_counts)
    _close(ours.node_counts, ref.node_counts)
    np.testing.assert_array_equal(ours.verified_rows, ref.verified_rows)
    assert len(ours.verified_rows) > 0
    rows = ours.verified_rows
    np.testing.assert_array_equal(ours.neighborhood_counts[rows],
                                  ref.neighborhood_counts[rows])
    assert np.abs(ours.graphlet_counts - ref.graphlet_counts).max() <= 1


def test_r4_service_loads_paper_config(port_service):
    svc = port_service
    assert svc.device == torch.device("cpu")
    assert (svc.tgt_cfg.layer_num, svc.tgt_cfg.hidden_dim,
            svc.tgt_cfg.n_edge_types) == (8, 64, 6)
    assert svc.tgt_cfg.agg_mode == "aggregate_first"  # CPU default
    conv = svc.neigh_params["target"]["conv"]
    assert tuple(conv.w.shape) == (8, 6, 64, 64)
    npz = np.load(NEIGH + ".params.npz")
    np.testing.assert_array_equal(conv.w.numpy(), npz["target/conv/0"])
    gate = svc.gossip_params["convs"][0]["gate"][1]
    np.testing.assert_array_equal(
        gate.w.numpy(), np.load(GOSSIP + ".params.npz")["convs/0/gate/1/0"])
    assert tuple(svc.query_embs.shape) == (29, 64)


def test_kernel_mode_and_stream_match_count(graphs, port_service, results):
    """agg_mode='kernel' (the wrapper's plain path on the CPU) and the
    pipelined stream give the same counts as count()."""
    tgraphs = graphs[1]
    ours, _ = results
    svc_k = CountingService(NEIGH, GOSSIP, device="cpu",
                            config_overrides={"agg_mode": "kernel"})
    assert svc_k.tgt_cfg.agg_mode == "kernel"
    _close(svc_k.count(tgraphs).neighborhood_counts,
           ours.neighborhood_counts)
    streamed = list(port_service.count_stream(
        [tgraphs[:2], tgraphs[2:5], tgraphs[5:]]))
    assert len(streamed) == 3
    per_req = [port_service.count(g)
               for g in (tgraphs[:2], tgraphs[2:5], tgraphs[5:])]
    for s, r in zip(streamed, per_req):
        np.testing.assert_array_equal(s.graphlet_counts, r.graphlet_counts)
        np.testing.assert_array_equal(s.verified_rows, r.verified_rows)


def test_exact_small_queries_and_unrefined(graphs):
    """exact_size=3 serves the wedge and triangle columns exactly; without
    a gossip checkpoint the stage-1 counts are packaged unrefined."""
    from desco_tpu_torch.truth.native import parallel_canonical_counts
    from desco_tpu_torch.graph import gen_queries

    tgraphs = graphs[1]
    svc = CountingService(NEIGH, GOSSIP, device="cpu",
                          config_overrides={"exact_size": 3})
    res = svc.count(tgraphs)
    exact = np.stack([c.sum(0) for c in parallel_canonical_counts(
        tgraphs, gen_queries([6, 7]))])
    np.testing.assert_array_equal(res.graphlet_counts[:, :2], exact)
    unrefined = CountingService(NEIGH, device="cpu").count(tgraphs)
    assert not unrefined.refined
    assert unrefined.graphlet_counts.shape == res.graphlet_counts.shape


def test_daemon_lines(graphs, port_service):
    from desco_tpu_torch.serve import serve_lines

    tgraphs = graphs[1]
    reqs = [{"id": 1, "graphs": [{"n": g.n_nodes,
                                  "edges": g.edges.tolist()}
                                 for g in tgraphs[:2]]},
            {"id": 2, "graphs": [{"n": 3, "edges": [[0, 1], [1, 2]]}],
             "node_counts": True},
            {"id": 3, "graphs": "not a list"}]
    out = io.StringIO()
    serve_lines(port_service,
                io.StringIO("".join(json.dumps(r) + "\n" for r in reqs)
                            + "quit\n"), out)
    replies = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["id"] for r in replies] == [1, 2, 3]
    np.testing.assert_array_equal(
        replies[0]["graphlet_counts"],
        port_service.count(tgraphs[:2]).graphlet_counts)
    assert replies[1]["graphlet_counts"][0][0] == 1.0  # one wedge
    assert len(replies[1]["node_counts"]) == 3
    assert "error" in replies[2]


def test_entry_points_default_to_cuda(monkeypatch):
    """With no GPU visible, the service and the daemon raise unless the
    caller asks for the CPU; nothing falls back silently."""
    from desco_tpu_torch.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CountingService(NEIGH, GOSSIP)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CountingService(NEIGH, GOSSIP, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--neigh_ckpt", NEIGH])
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("fn", [
    "pipeline.model_configs", "pipeline.neighborhood_predictions",
    "pipeline.stage_bounds", "pipeline.clamp_node_counts",
    "train.loop.predict_neighborhood_counts",
    "train.loop.predict_gossip_counts",
    "truth.bounds.neighborhood_count_bounds"])
def test_device_functions_take_no_default_device(fn):
    """The pipeline functions below the service name their device: left
    out, a call fails instead of running on the CPU."""
    import importlib
    import inspect

    mod, name = fn.rsplit(".", 1)
    f = getattr(importlib.import_module(f"desco_tpu_torch.{mod}"), name)
    param = inspect.signature(f).parameters["device"]
    assert param.default is inspect.Parameter.empty


@pytest.mark.parametrize("override", [
    {"serve_bf16": True}, {"use_node_feature": True}, {"order": 4},
    {"conv_type": "GAT"}, {"use_hetero": False}])
def test_unported_options_raise(override):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CountingService(NEIGH, device="cpu", config_overrides=override)


def test_unported_entry_points_raise(port_service, graphs):
    with pytest.raises(NotImplementedError, match="M16"):
        port_service.count_large_graph(graphs[1][0])
    with pytest.raises(NotImplementedError, match="M15"):
        CountingService(NEIGH, device="cpu", n_devices=2)
