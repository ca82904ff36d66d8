"""desco_tpu_torch's checkpoint ensembles and the daemon's ``--tcp`` mode
against desco_tpu's. Mirrors tests/test_serving.py (the ensemble service,
the TCP daemon) and tests/test_pipeline.py (the log-space mean).

Ensemble members are desco_tpu models (2 layers, width 16, query sizes
3-4, depth 2) written by desco_tpu's save_checkpoint and carried into
the port with ``params_from_jax`` / ``load_checkpoint``; graphs are small
(10-20 nodes). Tolerances: a one-member list equals the single path bit
for bit; the ensemble's stage-1 counts equal the log2(count + 1)-space
mean of its members' rtol 1e-5 (the same f32 forward, two numpy
reductions); against desco_tpu, counts rtol 1e-3 floored at 1e-2,
verified rows equal, graphlet counts within 1, and the CLI's six normed
MSE figures rtol 1e-3 (tests/test_torch_serving.py,
tests/test_torch_replay.py)."""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

import main as jmain
from desco_tpu.data.synthetic import generate_synthetic
from desco_tpu.models import neighborhood as jneigh
from desco_tpu.models.gossip import init_gossip_model
from desco_tpu.pipeline import PipelineConfig as JConfig
from desco_tpu.pipeline import model_configs as j_model_configs
from desco_tpu.train.checkpoint import _flatten
from desco_tpu.train.checkpoint import save_checkpoint as j_save
from desco_tpu_torch import main as tmain
from desco_tpu_torch import pipeline as tpipe
from desco_tpu_torch.data.synthetic import load_or_generate_synthetic
from desco_tpu_torch.graph import Graph
from desco_tpu_torch.models import neighborhood as tneigh
from desco_tpu_torch.serving import CountingService
from desco_tpu_torch.train.checkpoint import (
    flatten_params, load_checkpoint, params_from_jax)

from test_torch_shmp import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(query_sizes=(3, 4), depth=2, neigh_layer_num=2,
           neigh_hidden_dim=16, gossip_hidden_dim=16,
           agg_mode="aggregate_first")
SEEDS = (7, 8)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Two neighborhood members (same config, other weights) and one
    gossip model, written by desco_tpu."""
    d = tmp_path_factory.mktemp("ens")
    cfg = JConfig(**CFG)
    jt, jq = j_model_configs(cfg)
    members, jparams = [], []
    for seed in SEEDS:
        p = jneigh.init_neighborhood_model(jax.random.PRNGKey(seed), jt, jq)
        path = str(d / f"neigh{seed}")
        j_save(path, p, config=dataclasses.asdict(cfg))
        members.append(path)
        jparams.append(p)
    gp = init_gossip_model(jax.random.PRNGKey(1), input_dim=1, hidden_dim=16,
                           emb_channels=16, layer_num=2)
    gpath = str(d / "gossip")
    j_save(gpath, gp, config=dataclasses.asdict(cfg))
    return members, gpath, jparams


@pytest.fixture(scope="module")
def graphs():
    jg = generate_synthetic(5, min_size=10, max_size=20, seed=9)
    return jg, [Graph(g.n_nodes, g.edges.copy()) for g in jg]


def test_params_from_jax_takes_a_list_of_members(ckpts):
    members, _, jparams = ckpts
    trees = params_from_jax([_flatten(p) for p in jparams])
    assert isinstance(trees, list) and len(trees) == 2
    for tree, path, p in zip(trees, members, jparams):
        flat = flatten_params(tree)
        want = _flatten(p)
        assert set(flat) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(flat[k], v, k)
        loaded = flatten_params(load_checkpoint(path)[0])
        assert all(np.array_equal(loaded[k], v) for k, v in flat.items())


def test_singleton_ensemble_is_the_single_path(ckpts, graphs):
    members, gpath, _ = ckpts
    tg = graphs[1]
    solo = CountingService(members[0], gpath, device="cpu").count(tg)
    one = CountingService([members[0]], gpath, device="cpu")
    assert len(one.members) == len(one.member_embs) == 1
    single = one.count(tg)
    for f in ("graphlet_counts", "node_counts", "neighborhood_counts",
              "verified_rows"):
        np.testing.assert_array_equal(getattr(single, f), getattr(solo, f))


def test_ensemble_predictions_are_the_log_space_mean(ckpts, tmp_path):
    """At the pipeline layer (clamp and verification off): the ensemble
    is the log2(count + 1)-space mean of its members, a one-member list
    is the member, and desco_tpu's ensemble agrees."""
    from desco_tpu import pipeline as jpipe

    members, _, jparams = ckpts
    cfg = tpipe.PipelineConfig(clamp_counts=False, verify_budget=0.0, **CFG)
    jcfg = JConfig(clamp_counts=False, verify_budget=0.0, **CFG)
    jg = generate_synthetic(4, min_size=10, max_size=18, seed=3)
    tg = [Graph(g.n_nodes, g.edges.copy()) for g in jg]
    stage = tpipe.prepare_stage_data(cfg, tg)
    tt, tq = tpipe.model_configs(cfg, "cpu")
    qb = tpipe.build_query_batch(cfg)
    params = [load_checkpoint(m)[0].requires_grad_(False) for m in members]
    with torch.inference_mode():
        embs = [tneigh.embed_queries(p, tq, qb.to("cpu")) for p in params]
    c1, c2 = (tpipe.neighborhood_predictions(p, tt, e, stage, cfg, "cpu")[0]
              for p, e in zip(params, embs))
    ens = tpipe.neighborhood_predictions(params, tt, embs, stage, cfg,
                                         "cpu")[0]
    want = np.exp2(np.mean([np.log2(np.maximum(c, 0) + 1.0)
                            for c in (c1, c2)], axis=0)) - 1.0
    np.testing.assert_allclose(ens, want, rtol=1e-5, atol=1e-5)
    solo = tpipe.neighborhood_predictions([params[0]], tt, [embs[0]], stage,
                                          cfg, "cpu")[0]
    np.testing.assert_array_equal(solo, c1)
    with pytest.raises(ValueError, match="query embeddings"):
        tpipe.neighborhood_predictions(params, tt, embs[:1], stage, cfg,
                                       "cpu")
    jstage = jpipe.prepare_stage_data(jcfg, jg, "e", need_truth=False)
    jt, jq = j_model_configs(jcfg)
    ref = jpipe.neighborhood_predictions(
        jparams, jt, jq, jpipe.build_query_batch(jcfg), jstage, jcfg)
    np.testing.assert_allclose(ens, ref, rtol=1e-3, atol=1e-2)


def test_two_member_service_matches_desco_tpu(ckpts, graphs):
    """The ensemble service on both sides: the config rehydrates from the
    first member, gossip conditions on the first member's query
    embeddings, and every guard runs once on the mean."""
    from desco_tpu.serving import CountingService as JService

    members, gpath, _ = ckpts
    jg, tg = graphs
    svc = CountingService(members, gpath, device="cpu")
    assert len(svc.members) == len(svc.member_embs) == 2
    ours = svc.count(tg)
    ref = JService(members, gpath).count(jg)
    assert ours.refined and ref.refined
    np.testing.assert_allclose(ours.neighborhood_counts,
                               ref.neighborhood_counts, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(ours.node_counts, ref.node_counts,
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_array_equal(ours.verified_rows, ref.verified_rows)
    rows = ours.verified_rows
    assert len(rows) > 0
    np.testing.assert_array_equal(ours.neighborhood_counts[rows],
                                  ref.neighborhood_counts[rows])
    assert np.abs(ours.graphlet_counts - ref.graphlet_counts).max() <= 1
    solo = CountingService(members[0], gpath, device="cpu").count(tg)
    assert not np.array_equal(ours.neighborhood_counts,
                              solo.neighborhood_counts)


def test_cli_evaluates_the_ensemble_as_desco_tpu(ckpts, tmp_path):
    """``--neigh_checkpoint a b`` through both command lines on Syn_24
    (each with its own data root): normed MSE and per-node counts.
    Without tail verification: the untrained members predict nearly
    equal counts on many rows, so which rows rank in the verified tail
    turns on f32 rounding (the service test above holds the verified
    rows on distinct predictions)."""
    members, gpath, _ = ckpts
    roots = {k: str(tmp_path / k / "data") for k in ("t", "j")}
    load_or_generate_synthetic(24, os.path.join(roots["t"], "Syn_24"))
    shutil.copytree(os.path.join(roots["t"], "Syn_24"),
                    os.path.join(roots["j"], "Syn_24"))
    outs = {k: str(tmp_path / k / "out") for k in roots}
    argv = ["--test_gossip", "--neigh_checkpoint", *members,
            "--gossip_checkpoint", gpath, "--test_dataset", "Syn_24",
            "--num_cpu", "2", "--verify_budget", "0"]
    assert tmain.main(argv + ["--device", "cpu", "--data_root", roots["t"],
                              "--output_dir", outs["t"]]) == 0
    assert jmain.main(argv + ["--data_root", roots["j"],
                              "--output_dir", outs["j"]]) == 0

    def metrics(out):
        with open(os.path.join(out, "analyze_results_Syn_24.txt")) as f:
            return {k: np.array(json.loads(v)) for k, v in
                    (line.split(": ", 1) for line in f)}

    got, want = metrics(outs["t"]), metrics(outs["j"])
    assert set(got) == set(want) and len(got) == 4
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    for stem in ("neighborhood_node_Syn_24_results", "gossip_node_Syn_24"
                 "_results"):
        a, b = (np.loadtxt(os.path.join(o, stem + ".csv"), delimiter=",",
                           skiprows=1, ndmin=2)[:, 1:]
                for o in (outs["t"], outs["j"]))
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-2)


# ---------------------------------------------------------------- daemon
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_daemon_tcp_round_trip(ckpts, graphs):
    """``python -m desco_tpu_torch.serve --tcp`` in a subprocess, serving
    the two-member ensemble: one request over a real localhost socket
    answers what ``CountingService.count`` answers in this process; a
    second connection is served after the first closes."""
    members, gpath, _ = ckpts
    tg = graphs[1][:3]
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "desco_tpu_torch.serve", "--neigh_ckpt",
         *members, "--gossip_ckpt", gpath, "--device", "cpu", "--tcp",
         f"127.0.0.1:{port}"], cwd=REPO, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        for line in proc.stderr:
            if line.startswith("listening on"):
                break
        else:
            pytest.fail(f"the daemon exited {proc.wait()} before listening")
        req = {"id": 11, "graphs": [{"n": g.n_nodes,
                                     "edges": g.edges.tolist()} for g in tg]}
        replies = []
        for rid in (11, 12):
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=120) as c:
                rf, wf = c.makefile("r"), c.makefile("w")
                wf.write(json.dumps({**req, "id": rid}) + "\nquit\n")
                wf.flush()
                replies.append(json.loads(rf.readline()))
    finally:
        proc.kill()
        proc.wait()
    want = CountingService(members, gpath, device="cpu").count(tg)
    assert [r["id"] for r in replies] == [11, 12]
    for r in replies:
        assert r["refined"] and r["verified"] == len(want.verified_rows)
        np.testing.assert_array_equal(r["graphlet_counts"],
                                      want.graphlet_counts)


def test_daemon_flags_of_unported_features_raise(ckpts, graphs, tmp_path,
                                                  monkeypatch, capsys):
    """The daemon's ``--n_devices 2`` (two data-parallel replicas) and
    ``--compile_cache`` run now: an ensemble request answers as one
    device does."""
    import io
    import sys

    from desco_tpu_torch.ops import cuda_build
    from desco_tpu_torch.serve import main
    from desco_tpu_torch.truth import native

    members, gpath, _ = ckpts
    _, tg = graphs
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(native, "_BUILD_DIR", native._BUILD_DIR)
    req = {"id": 3, "graphs": [{"n": g.n_nodes, "edges": g.edges.tolist()}
                               for g in tg]}
    monkeypatch.setattr(sys, "stdin", io.StringIO(json.dumps(req)
                                                  + "\nquit\n"))
    assert main(["--neigh_ckpt", *members, "--gossip_ckpt", gpath,
                 "--device", "cpu", "--n_devices", "2",
                 "--compile_cache", str(tmp_path / "c")]) == 0
    reply = json.loads(capsys.readouterr().out.strip())
    assert cuda_build.BUILD_DIR == str(tmp_path / "c" / "kernels")
    want = CountingService(members, gpath, device="cpu").count(tg)
    assert reply["id"] == 3 and reply["refined"]
    assert reply["verified"] == len(want.verified_rows)
    np.testing.assert_array_equal(reply["graphlet_counts"],
                                  want.graphlet_counts)
