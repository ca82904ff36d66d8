"""BENCHMARK.json parses, keeps to the benchmark's contract, and every
cell's configuration, traffic mix, limits and metric readers are found
by name."""

import json
import os
import re

import pytest

from h100bench.lib import harness
from h100bench.lib import weights as wt
from h100bench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.benchmark(REPO)


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["h100bench"]
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert "\n" not in word and "\t" not in word and 1 <= len(word) <= 200
        assert not word.startswith("/") and ".." not in word
    assert os.path.isfile(os.path.join(REPO, bench["command"][1]))
    assert bench["command"][1].startswith("h100bench/")
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024


def test_run_seconds_fit_the_check_with_24_cells(bench):
    r = bench["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    cells = 24
    assert (2 + 14 * cells) * (r + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert len(c["reduced"]) <= 16
        names.append(("config", c["name"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(("cell", w["name"]))
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            allowed = {"name", "unit", "better", "source", "workloads"}
            allowed |= ({"bound"} if kind == "end_to_end"
                        else {"layer", "moves"})
            assert set(m) <= allowed and set(m) >= allowed - {"workloads"}
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            names.append(("metric", m["name"]))
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in bench["end_to_end"])


def test_every_cell_found_by_name(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        entry, cfg, traffic = harness.cell_files(bench, REPO, w["name"])
        assert cfg["name"] == w["config"]
        assert os.path.isfile(os.path.join(
            harness.BENCH_DIR, "drivers", traffic["driver"] + ".py"))
        lim = harness.limits(w["name"])
        assert lim and all(v >= 0 for v in lim.values())
        mine = harness.cell_metrics(bench, w["name"], "end_to_end", None)
        mine_names = {m["name"] for m in mine}
        assert "setup_s" in mine_names and len(mine_names) >= 2
        layer = harness.cell_metrics(bench, w["name"], "per_layer",
                                     mine_names)
        assert layer
        for m in layer:
            assert m["moves"] in mine_names
            assert callable(harness.load_reader(m["name"]))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", ()):
            assert cell in {w["name"] for w in bench["workloads"]}


def test_config_files_hold_what_runs(bench):
    for c in bench["configs"]:
        path = os.path.join(REPO, c["file"])
        assert c["file"].startswith("h100bench/configs/")
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["dtype"] == "float32" and cfg["allow_tf32"] is False
        assert (cfg["neigh_layer_num"], cfg["neigh_hidden_dim"],
                cfg["gossip_hidden_dim"]) == (8, 64, 64)


def test_files_are_named_from_name_characters():
    for dirpath, dirnames, filenames in os.walk(harness.BENCH_DIR):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".build")]
        rel = os.path.relpath(dirpath, harness.BENCH_DIR)
        for part in ([] if rel == "." else rel.split(os.sep)) + filenames:
            assert re.match(r"^[A-Za-z0-9_.-]+$", part), part


@pytest.mark.parametrize("conv", ["SAGE", "GAT"])
def test_weight_layout_is_the_programs(conv):
    """The leaves the benchmark makes are the program's parameters, key
    for key and shape for shape."""
    from desco_tpu_torch.models.gossip import init_gossip_model
    from desco_tpu_torch.models.neighborhood import init_neighborhood_model
    from desco_tpu_torch.pipeline import PipelineConfig, model_configs
    from desco_tpu_torch.train.checkpoint import flatten_params

    with open(os.path.join(harness.BENCH_DIR, "configs",
                           "desco-sage-r4.json")) as f:
        cfg = dict(json.load(f), conv_type=conv)
    tgt, qry = model_configs(PipelineConfig(**wt.pipeline_config(cfg)),
                             "cpu")
    prog = {k: v.shape for k, v in flatten_params(
        init_neighborhood_model(tgt, qry)).items()}
    assert prog == {k: tuple(s) for k, s, _ in wt.neighborhood_specs(cfg)}
    gossip = {k: v.shape for k, v in flatten_params(init_gossip_model(
        1, cfg["gossip_hidden_dim"], cfg["neigh_hidden_dim"],
        cfg["gossip_layer_num"])).items()}
    assert gossip == {k: tuple(s) for k, s, _ in wt.gossip_specs(cfg)}


@pytest.mark.parametrize("where", ["weights", "flops", "reference"])
def test_an_unknown_conv_type_is_refused(where):
    """A configuration whose layer has no ``convs/<conv_type>.py`` is
    refused, not reckoned as another layer."""
    import torch

    from h100bench.lib import flops as fl
    from h100bench.reference import graphs as rg
    from h100bench.reference import model as rm

    with open(os.path.join(harness.BENCH_DIR, "configs",
                           "desco-sage-r4.json")) as f:
        cfg = dict(json.load(f), conv_type="GIN")
    with pytest.raises(ValueError, match="convs/GIN.py"):
        if where == "weights":
            wt.neighborhood_specs(cfg)
        elif where == "flops":
            fl.tower_flops({"n": 4, "e": 6, "g": 1, "runs": 3}, cfg, 6)
        else:
            w = wt.make_weights(wt.neighborhood_specs(
                dict(cfg, conv_type="SAGE")), 1, 0, torch.device("cpu"))
            rm.tower(w, "query", "GIN", rg.query_batch("cpu"), rm.QUERY_DST)


def test_kernel_patterns_are_data():
    pats = harness.patterns("aggregation_roofline.train")
    assert "typed_aggregate_fwd_kernel" in pats
    assert "segsum_pair_kernel" in pats
