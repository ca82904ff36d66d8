"""Each cell's run at a tiny size on the CPU, with the kernels' plain
versions, agrees with the plain reference; and the reference in TF32
(the control) fails the cell's limits."""

import importlib
import time

import numpy as np
import pytest
import torch

from h100bench import calibrate
from h100bench.gen import syn1827
from h100bench.lib import harness
from h100bench.reference import graphs as rg
from h100bench.tests.conftest import SEED, run_tiny, tiny

CELLS = ["sage-r4.serve-32g", "sage-r4.train-b512", "gat.train-b512"]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_agrees_with_the_reference(cell):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    for name, c in res["checks"].items():
        assert c["value"] < 1e-4, (name, c)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell):
    """The reference in TF32, in the program's place, and every planted
    fault of ``calibrate.py``, on a tiny cell: each comes out not
    correct, judged as a run judges its own."""
    bench, entry, cfg, traffic = tiny(cell)
    lim = harness.limits(cell)
    driver = importlib.import_module(f"h100bench.drivers.{traffic['driver']}")
    out = driver.run(entry, cfg, traffic, SEED, 1.0, False,
                     torch.device("cpu"), time.perf_counter(),
                     harness.BUILD_DIR)
    assert harness.judge(out["numbers"], lim)["ok"], out["numbers"]
    readings = calibrate.READINGS[traffic["driver"]](out["reference"])
    assert "control" in readings and len(readings) >= 2
    for kind, numbers in readings.items():
        assert not harness.judge(numbers, lim)["ok"], (kind, numbers, lim)


def test_decomposition_follows_the_definition():
    """The reference's neighborhoods against a direct walk of the
    definition on a few graphs: the depth-4 ball, nodes <= v, v's
    component, edgeless ones dropped."""
    graphs = syn1827.make_graphs(syn1827.grid_ids(12, 20)[:6], 3)
    dec = rg.decompose(graphs, 4, "cpu")
    k = 0
    for gid, (n, edges) in enumerate(graphs):
        adj = [set() for _ in range(n)]
        for a, b in edges:
            adj[a].add(int(b))
            adj[b].add(int(a))
        for v in range(n):
            ball, front = {v}, {v}
            for _ in range(4):
                front = {u for w in front for u in adj[w]} - ball
                ball |= front
            keep = {u for u in ball if u <= v}
            comp, front = {v}, {v}
            while front:
                front = {u for w in front for u in adj[w] & keep} - comp
                comp |= front
            m = sum(1 for a, b in edges if a in comp and b in comp)
            if m == 0:
                continue
            assert tuple(dec.index[k]) == (gid, v)
            assert set(dec.nodes(k).tolist()) == comp
            assert dec.n_edges[k] == m
            k += 1
    assert k == len(dec.index)


def test_greedy_batches_cut_where_a_sample_does_not_fit():
    nodes = np.array([3, 4, 5, 2, 6])
    edges = np.array([2, 3, 4, 1, 5])
    # n_cap 10 leaves 9 node slots; g_cap 2
    assert rg.greedy_batches(nodes, edges, 10, 100, 2) == [
        (0, 2), (2, 4), (4, 5)]
    # directed edges 4, 6, 8, 2, 10 against e_cap 9
    assert rg.greedy_batches(nodes, edges, 100, 9, 9) == [
        (0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]
