"""The release/r4 replay through both command lines on the CPU:
``python -m desco_tpu_torch.main --device cpu --test_gossip`` against
desco_tpu's root ``main.py`` on ``Syn_1827_test_max15`` (73 graphs, 906
nodes), each with its own data root, so each computes its own truth and
sample cache (the raw files of Syn_1827 are generated once and copied
into both roots: generation parity is held in test_torch_datasets.py);
and ``python -m desco_tpu_torch.gen_dataset``, with its truth shards,
against desco_tpu's truth and samples."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import main as jmain
from desco_tpu.data.workload import Workload as JWorkload
from desco_tpu.graph.atlas import gen_query_ids
from desco_tpu_torch import gen_dataset as tgen
from desco_tpu_torch import main as tmain
from desco_tpu_torch.data.datasets import load_data
from desco_tpu_torch.data.synthetic import load_or_generate_synthetic

from test_torch_shmp import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(REPO, "release", "r4")
DS = "Syn_1827_test_max15"
RTOL = 1e-3


def _csv(out_dir, stem):
    return np.loadtxt(os.path.join(out_dir, f"{stem}_{DS}.csv"),
                      delimiter=",", skiprows=1, ndmin=2)[:, 1:]


def _metrics(out_dir):
    got = {}
    with open(os.path.join(out_dir, f"analyze_results_{DS}.txt")) as f:
        for line in f:
            key, val = line.split(": ", 1)
            got[key] = np.array(json.loads(val))
    return got


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    base = tmp_path_factory.mktemp("replay")
    roots = {k: str(base / k / "data") for k in ("t", "j")}
    load_or_generate_synthetic(1827, os.path.join(roots["t"], "Syn_1827"))
    shutil.copytree(os.path.join(roots["t"], "Syn_1827"),
                    os.path.join(roots["j"], "Syn_1827"))
    outs = {k: str(base / k / "out") for k in roots}
    argv = ["--test_gossip",
            "--neigh_checkpoint", os.path.join(R4, "neigh.best"),
            "--gossip_checkpoint", os.path.join(R4, "gossip.best"),
            "--test_dataset", DS, "--num_cpu", "2"]
    assert tmain.main(argv + ["--device", "cpu", "--data_root", roots["t"],
                              "--output_dir", outs["t"]]) == 0
    assert jmain.main(argv + ["--data_root", roots["j"],
                              "--output_dir", outs["j"]]) == 0
    return roots, outs


def test_each_package_computed_its_own_caches(replays):
    roots, _ = replays
    for root in roots.values():
        ds_root = os.path.join(root, DS)
        assert os.listdir(os.path.join(ds_root, "CanonicalCountTruth"))
        assert os.listdir(os.path.join(ds_root, "NeighborhoodDataset"))


def test_truth_is_equal(replays):
    _, outs = replays
    truth = _csv(outs["t"], "graphlet_truth")
    assert truth.shape == (73, 29)
    np.testing.assert_array_equal(truth, _csv(outs["j"], "graphlet_truth"))


@pytest.mark.parametrize("stem", ["neighborhood_graphlet", "gossip_graphlet",
                                  "graphlet_count"])
def test_per_graph_counts_agree(replays, stem):
    """Per-graph graphlet counts within rtol 1e-3, floored at 1."""
    _, outs = replays
    mine, theirs = _csv(outs["t"], stem), _csv(outs["j"], stem)
    assert mine.shape == theirs.shape == (73, 29)
    err = np.abs(mine - theirs) / np.maximum(np.abs(theirs), 1.0)
    assert err.max() <= RTOL, f"{stem}: {err.max():.3g}"


def test_normed_mse_agrees(replays):
    _, outs = replays
    mine, theirs = _metrics(outs["t"]), _metrics(outs["j"])
    for key in ("graphlet_norm_mse_neighborhood", "graphlet_norm_mse_gossip"):
        assert len(mine[key]) == 3
        np.testing.assert_allclose(mine[key], theirs[key], rtol=RTOL)


def test_gen_dataset_command(tmp_path):
    """``python -m desco_tpu_torch.gen_dataset`` writes the truth and the
    sample cache that desco_tpu's Workload reads as its own."""
    root = str(tmp_path / "data")
    proc = subprocess.run(
        [sys.executable, "-m", "desco_tpu_torch.gen_dataset", "--dataset",
         "Syn_64_test_max30", "--depth", "3", "--query_sizes", "3", "4",
         "--data_root", root, "--num_cpu", "2"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ground truth" in proc.stdout and "staged" in proc.stdout
    graphs = load_data("Syn_64_test_max30", root)
    jwl = JWorkload(graphs, os.path.join(root, "Syn_64_test_max30"))
    qids = gen_query_ids([3, 4])
    truth = np.load(jwl.groundtruth_path(qids))
    np.testing.assert_array_equal(
        truth, jwl.compute_groundtruth(qids, use_cache=False))
    samples, _ = jwl.neighborhood_samples(3, qids)
    assert isinstance(samples[0].edge_src, np.memmap)  # the port's cache


def test_gen_dataset_shards(tmp_path):
    root = str(tmp_path / "data")
    base = ["--dataset", "Syn_64_val", "--depth", "3", "--query_sizes", "3",
            "4", "--data_root", root, "--num_shards", "3"]
    for k in range(3):
        assert tgen.main(base + ["--shard", str(k)]) == 0
    ds_root = os.path.join(root, "Syn_64_val")
    qids = gen_query_ids([3, 4])
    jwl = JWorkload(load_data("Syn_64_val", root), ds_root)
    assert not os.path.exists(jwl.groundtruth_path(qids))
    assert tgen.main(base + ["--merge_shards"]) == 0
    np.testing.assert_array_equal(
        np.load(jwl.groundtruth_path(qids)),
        jwl.compute_groundtruth(qids, use_cache=False))
    assert os.listdir(os.path.join(ds_root, "NeighborhoodDataset"))


def test_chip_smoke_replay_reference_is_one_run():
    """chip_smoke.py holds the card's replay of Syn_1827_test_max40 against
    desco_tpu's CPU run twice: its six normed-MSE figures and its per-graph
    counts. The committed counts give back the committed figures."""
    import chip_smoke
    from desco_tpu.analysis import norm_mse
    from desco_tpu_torch.pipeline import PipelineConfig, pipeline_query_groups

    ref = np.load(chip_smoke.REPLAY_CPU_COUNTS)
    assert sorted(ref.files) == ["gossip", "neighborhood", "truth"]
    groups = pipeline_query_groups(PipelineConfig())
    for stage, want in chip_smoke.REPLAY_CPU_MSE.items():
        assert ref[stage].shape == (354, 29)
        np.testing.assert_allclose(
            norm_mse(ref[stage], ref["truth"], groups), want, rtol=1e-12)
