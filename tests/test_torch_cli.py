"""``python -m desco_tpu_torch.main`` on the CPU: the flag surface agrees
with desco_tpu's, a tiny model trains end to end and serves from the
checkpoints it wrote, the default device is the GPU (and raises without
one), and options of unported features raise naming ROADMAP.md."""

import dataclasses
import os
import random

import numpy as np
import pytest
import torch

from desco_tpu.config import build_parser as j_build_parser
from desco_tpu.config import to_pipeline_config as j_to_pipeline_config
from desco_tpu_torch import main as tmain
from desco_tpu_torch.config import build_parser, to_pipeline_config
from desco_tpu_torch.data.datasets import load_data
from desco_tpu_torch.serving import CountingService

from test_torch_shmp import one_torch_thread  # noqa: F401

TINY_FLAGS = [
    "--neigh_layer_num", "2", "--neigh_hidden_dim", "16",
    "--gossip_hidden_dim", "16", "--query_sizes", "3", "4",
    "--neigh_epoch_num", "3", "--gossip_epoch_num", "2",
    "--neigh_batch_size", "64", "--gossip_batch_size", "4",
    "--num_cpu", "2", "--train_dataset", "SynNp_4",
    "--valid_dataset", "SynNp_4", "--test_dataset", "SynNp_2_1"]


def test_flag_surface_matches_desco_tpu():
    """Every flag of desco_tpu's parser parses here with the same default
    (the checkpoint paths aside), and the resulting
    PipelineConfig agrees field by field."""
    jp, tp = j_build_parser(), build_parser()
    jflags = {a.dest: a.default for a in jp._actions if a.dest != "help"}
    tflags = {a.dest: a.default for a in tp._actions if a.dest != "help"}
    assert set(jflags) <= set(tflags)
    assert set(tflags) - set(jflags) == {"device"}
    differ = {k for k in jflags if jflags[k] != tflags[k]}
    assert differ == {"neigh_model_path", "gossip_model_path"}
    argv = ["--neigh_lr", "3e-4", "--gossip_dropout", "0.2", "--val_every",
            "2", "--seed", "5", "--query_ids", "6", "7", "--no-use_tconv"]
    jcfg = dataclasses.asdict(j_to_pipeline_config(jp.parse_args(argv)))
    tcfg = dataclasses.asdict(to_pipeline_config(tp.parse_args(argv)))
    assert tcfg == {k: jcfg[k] for k in tcfg}
    assert set(jcfg) == set(tcfg)


def test_datasets_take_desco_tpu_names(tmp_path):
    a, b = load_data("SynNp_5"), load_data("SynNp_5_0")
    assert len(a) == 5
    assert all(np.array_equal(g.edges, h.edges) for g, h in zip(a, b))
    c = load_data("SynNp_5_1")
    assert any(g.n_nodes != h.n_nodes or not np.array_equal(g.edges, h.edges)
               for g, h in zip(a, c))
    for name in ("SynNp_x", "NoSuchDataset"):
        with pytest.raises(NotImplementedError, match="unknown dataset"):
            load_data(name, str(tmp_path))
    with pytest.raises(FileNotFoundError,
                       match=os.path.join(str(tmp_path), "MUTAG", "raw")):
        load_data("MUTAG", str(tmp_path))
    # desco_tpu's suffix rule: random.Random(0).shuffle, 25 / 25 / 50
    idx = list(range(5))
    random.Random(0).shuffle(idx)
    assert [g.n_nodes for g in load_data("SynNp_5_train")] == [
        a[i].n_nodes for i in idx[:1]]
    assert all(np.array_equal(g.edges, a[i].edges) for g, i in zip(
        load_data("SynNp_5_test"), idx[2:]))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One tiny CLI training run on the CPU, shared by the tests below."""
    root = tmp_path_factory.mktemp("cli")
    paths = dict(data=str(root / "data"), out=str(root / "out"),
                 neigh=str(root / "ck" / "neigh"),
                 gossip=str(root / "ck" / "gossip"))
    rc = tmain.main(TINY_FLAGS + [
        "--device", "cpu", "--train_neigh", "--train_gossip",
        "--test_gossip", "--data_root", paths["data"],
        "--output_dir", paths["out"], "--neigh_model_path", paths["neigh"],
        "--gossip_model_path", paths["gossip"]])
    assert rc == 0
    return paths


def test_cli_trains_and_writes_outputs(trained):
    out = trained["out"]
    for name in ("gossip_gate_SynNp_2_1.csv", "graphlet_count_SynNp_2_1.csv",
                 "graphlet_truth_SynNp_2_1.csv",
                 "neighborhood_node_SynNp_2_1_results.csv",
                 "gossip_node_SynNp_2_1_results.csv",
                 "analyze_results_SynNp_2_1.txt",
                 "test_graphs_SynNp_2_1.npz"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "analyze_results_SynNp_2_1.txt")) as f:
        lines = f.read().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "graphlet_norm_mse_neighborhood", "graphlet_mae_neighborhood",
        "graphlet_norm_mse_gossip", "graphlet_mae_gossip"]
    gates = np.loadtxt(os.path.join(out, "gossip_gate_SynNp_2_1.csv"),
                       delimiter=",", skiprows=1)
    assert gates.shape == (2, 1 + 8)  # 2 layers x (index + 8 queries)
    assert ((gates[:, 1:] > 0) & (gates[:, 1:] < 1)).all()
    for stem in (trained["neigh"], trained["gossip"]):
        for suffix in (".best.params.npz", ".best.json", ".last.params.npz",
                       ".last.opt.npz"):
            assert os.path.exists(stem + suffix), stem + suffix
    assert os.path.exists(os.path.join(
        trained["data"], "SynNp_4", "CanonicalCountTruth"))


def test_service_serves_the_checkpoints_the_cli_wrote(trained):
    svc = CountingService(trained["neigh"] + ".best",
                          trained["gossip"] + ".best", device="cpu")
    assert svc.cfg.neigh_hidden_dim == 16 and svc.cfg.query_sizes == (3, 4)
    graphs = load_data("SynNp_2_1")
    res = svc.count(graphs)
    assert res.graphlet_counts.shape == (2, 8) and res.refined
    assert np.isfinite(res.graphlet_counts).all()
    got = np.loadtxt(os.path.join(trained["out"],
                                  "graphlet_count_SynNp_2_1.csv"),
                     delimiter=",", skiprows=1)[:, 1:]
    np.testing.assert_allclose(res.graphlet_counts, got, rtol=1e-4, atol=1.0)


def test_cli_evaluates_from_checkpoints_and_adopts_their_config(
        trained, tmp_path, capsys):
    """Eval-only: the model fields come from the checkpoint's config, not
    from the (default, paper-width) flags."""
    rc = tmain.main([
        "--device", "cpu", "--test_gossip", "--test_dataset", "SynNp_2_1",
        "--num_cpu", "2", "--data_root", trained["data"],
        "--output_dir", str(tmp_path / "out"),
        "--neigh_checkpoint", trained["neigh"] + ".best",
        "--gossip_checkpoint", trained["gossip"] + ".best"])
    assert rc == 0
    said = capsys.readouterr().out
    assert "adopting neigh_hidden_dim=16" in said
    assert "adopting query_sizes=(3, 4)" in said
    a = np.loadtxt(tmp_path / "out" / "graphlet_count_SynNp_2_1.csv",
                   delimiter=",", skiprows=1)
    b = np.loadtxt(os.path.join(trained["out"],
                                "graphlet_count_SynNp_2_1.csv"),
                   delimiter=",", skiprows=1)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_cli_default_device_is_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(TINY_FLAGS + ["--train_neigh", "--output_dir",
                                 str(tmp_path)])


MESH_2 = "data-parallel mesh: 2 devices"


@pytest.mark.parametrize("flags,match", [
    pytest.param(["--n_devices", "2"], MESH_2, id="flags0-M15"),
    pytest.param(["--n_devices", "0"], None, id="flags1-M15"),
    pytest.param(["--compile_cache", "x"], None, id="flags2-M17"),
    pytest.param(["--neigh_bf16_train", "--train_neigh", "--n_devices", "2"],
                 MESH_2, id="flags3-M15"),
])
def test_unported_options_raise_naming_the_roadmap(tmp_path, capsys,
                                                   monkeypatch, flags,
                                                   match):
    """desco_tpu's multi-device options run: ``--n_devices 2`` trains over
    two data-parallel replicas on the CPU, ``--n_devices 0`` (every
    device) is one CPU replica, and ``--compile_cache DIR`` points the
    build directories into DIR."""
    from desco_tpu_torch.ops import cuda_build
    from desco_tpu_torch.truth import native

    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(native, "_BUILD_DIR", native._BUILD_DIR)
    flags = [str(tmp_path / f) if f == "x" else f for f in flags]
    rc = tmain.main(TINY_FLAGS + flags + [
        "--device", "cpu", "--data_root", str(tmp_path / "d"),
        "--output_dir", str(tmp_path / "o"), "--train_neigh",
        "--neigh_model_path", str(tmp_path / "n")])
    out = capsys.readouterr().out
    assert rc == 0 and "done" in out
    assert (match in out) if match else "data-parallel mesh" not in out
    if "--compile_cache" in flags:
        assert cuda_build.BUILD_DIR == str(tmp_path / "x" / "kernels")
        assert native._BUILD_DIR == str(tmp_path / "x" / "native")
