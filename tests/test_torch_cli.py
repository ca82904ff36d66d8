"""``python -m desco_tpu_torch.main`` on the CPU: the flag surface agrees
with desco_tpu's, a tiny model trains end to end and serves from the
checkpoints it wrote, the default device is the GPU (and raises without
one), and options of unported features raise naming ROADMAP.md."""

import dataclasses
import os

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
    (dataset names and checkpoint paths aside), and the resulting
    PipelineConfig agrees field by field."""
    jp, tp = j_build_parser(), build_parser()
    jflags = {a.dest: a.default for a in jp._actions if a.dest != "help"}
    tflags = {a.dest: a.default for a in tp._actions if a.dest != "help"}
    assert set(jflags) <= set(tflags)
    assert set(tflags) - set(jflags) == {"device"}
    differ = {k for k in jflags if jflags[k] != tflags[k]}
    assert differ == {"train_dataset", "valid_dataset", "test_dataset",
                      "neigh_model_path", "gossip_model_path", "n_devices"}
    argv = ["--neigh_lr", "3e-4", "--gossip_dropout", "0.2", "--val_every",
            "2", "--seed", "5", "--query_ids", "6", "7", "--no-use_tconv"]
    jcfg = dataclasses.asdict(j_to_pipeline_config(jp.parse_args(argv)))
    tcfg = dataclasses.asdict(to_pipeline_config(tp.parse_args(argv)))
    assert tcfg == {k: jcfg[k] for k in tcfg}
    assert set(jcfg) == set(tcfg)


def test_datasets_know_synnp_only():
    a, b = load_data("SynNp_5"), load_data("SynNp_5_0")
    assert len(a) == 5
    assert all(np.array_equal(g.edges, h.edges) for g, h in zip(a, b))
    c = load_data("SynNp_5_1")
    assert any(g.n_nodes != h.n_nodes or not np.array_equal(g.edges, h.edges)
               for g, h in zip(a, c))
    for name in ("Syn_1827", "MUTAG", "SynNp_x", "SynNp_5_train"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            load_data(name)


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


@pytest.mark.parametrize("flags,match", [
    (["--n_devices", "2"], "M15"),
    (["--n_devices", "0"], "M15"),
    (["--compile_cache", "x"], "M17"),
    (["--neigh_checkpoint", "a", "b"], "M11"),
    (["--neigh_bf16_train", "--train_neigh"], "M12"),
    (["--serve_bf16", "--train_neigh"], "ROADMAP"),
    (["--use_node_feature", "--train_neigh"], "ROADMAP"),
    (["--neigh_order", "4", "--train_neigh"], "ROADMAP"),
    (["--neigh_conv_type", "GIN", "--train_neigh"], "ROADMAP"),
    (["--train_dataset", "Syn_1827", "--train_neigh"], "ROADMAP"),
])
def test_unported_options_raise_naming_the_roadmap(tmp_path, flags, match):
    base = [a for a in TINY_FLAGS]
    if "--train_dataset" in flags:
        i = base.index("--train_dataset")
        del base[i:i + 2]
    with pytest.raises(NotImplementedError, match=match):
        tmain.main(base + flags + [
            "--device", "cpu", "--data_root", str(tmp_path / "d"),
            "--output_dir", str(tmp_path / "o"),
            "--neigh_model_path", str(tmp_path / "n")])
