"""desco_tpu_torch's single-large-graph serving
(``CountingService.count_large_graph``: stage 1 packed, the gossip
halo-sharded) and the daemon's ``--large_threshold`` routing, on the CPU,
on the release/r4 checkpoints.

Tolerances (tests/test_serving.py:133-153): node counts rtol 1e-4 (atol
1e-4, a count near zero), graphlet counts within 1 (a rounded sum that
sits at a rounding boundary); the unrefined path equal."""

import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from desco_tpu.data.synthetic import generate_synthetic
from desco_tpu_torch.graph import Graph
from desco_tpu_torch.serve import handle, serve_lines
from desco_tpu_torch.serving import CountingService
from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)

NEIGH, GOSSIP = "release/r4/neigh.best", "release/r4/gossip.best"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def graph():
    [jg] = generate_synthetic(1, min_size=55, max_size=60, seed=33)
    return jg, Graph(jg.n_nodes, jg.edges.copy())


@pytest.fixture(scope="module")
def svc():
    return CountingService(NEIGH, GOSSIP, device="cpu")


def close(got, want):
    np.testing.assert_allclose(got.node_counts, want.node_counts,
                               rtol=1e-4, atol=1e-4)
    assert np.abs(got.graphlet_counts - want.graphlet_counts).max() <= 1


def test_count_large_graph_matches_desco_tpu(graph, svc):
    from desco_tpu.serving import CountingService as JService

    jg, g = graph
    want = JService(NEIGH, GOSSIP).count_large_graph(jg, n_devices=4)
    got = svc.count_large_graph(g, n_devices=4)
    assert got.refined and want.refined
    assert got.graphlet_counts.shape == (1, 29)
    close(got, want)
    np.testing.assert_array_equal(got.verified_rows, want.verified_rows)


@pytest.mark.parametrize("n_devices", [0, 1, 4])
def test_count_large_graph_matches_count(graph, svc, n_devices):
    """The halo-sharded gossip equals the packed one on a graph small
    enough to run both ways; 0 shards is one on the CPU."""
    g = graph[1]
    close(svc.count_large_graph(g, n_devices=n_devices), svc.count([g]))


def test_count_large_graph_unrefined_and_guards(graph, svc):
    g = graph[1]
    got = svc.count_large_graph(g, refine=False)
    assert not got.refined
    np.testing.assert_array_equal(got.graphlet_counts,
                                  svc.count([g], refine=False)
                                  .graphlet_counts)
    # an edgeless graph: all-zero counts
    empty = svc.count_large_graph(Graph(5, np.zeros((0, 2), np.int32)))
    assert empty.graphlet_counts.shape == (1, 29)
    assert not empty.graphlet_counts.any()
    assert empty.node_counts.shape == (5, 29)
    # the refine guard on the halo path
    with pytest.raises(ValueError, match="gossip"):
        CountingService(NEIGH, device="cpu").count_large_graph(
            g, refine=True)


class Recorder:
    """A service stand-in that records which entry a request reached."""

    def __init__(self, svc):
        self.svc, self.calls = svc, []

    def count(self, graphs, refine=None):
        self.calls.append(("count", len(graphs)))
        return self.svc.count(graphs, refine=refine)

    def count_large_graph(self, graph, refine=None):
        self.calls.append(("count_large_graph", graph.n_nodes))
        return self.svc.count_large_graph(graph, refine=refine)


def request(rid, graphs, **kw):
    return {"id": rid, "graphs": [{"n": g.n_nodes, "edges": g.edges.tolist()}
                                  for g in graphs], **kw}


def test_large_threshold_routing_over_stdio(graph, svc):
    g = graph[1]
    small = Graph(3, np.array([[0, 1], [1, 2]], np.int32))
    rec = Recorder(svc)
    lines = [request(1, [g], node_counts=True), request(2, [small]),
             request(3, [g, small])]
    out = io.StringIO()
    serve_lines(rec, io.StringIO("".join(json.dumps(r) + "\n"
                                         for r in lines) + "quit\n"),
                out, large_threshold=g.n_nodes)
    assert rec.calls == [("count_large_graph", g.n_nodes), ("count", 1),
                         ("count", 2)]
    replies = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["id"] for r in replies] == [1, 2, 3]
    want = svc.count_large_graph(g)
    np.testing.assert_array_equal(replies[0]["graphlet_counts"],
                                  want.graphlet_counts)
    np.testing.assert_allclose(replies[0]["node_counts"], want.node_counts,
                               rtol=1e-6)
    # the default threshold, 5000 nodes, leaves this graph to count()
    rec.calls.clear()
    handle(rec, request(4, [g]))
    assert rec.calls == [("count", 1)]


def test_large_threshold_routing_over_tcp(graph, svc):
    """``python -m desco_tpu_torch.serve --tcp --large_threshold N`` in a
    subprocess: a one-graph request of N nodes answers what
    ``count_large_graph`` answers in this process."""
    g = graph[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "desco_tpu_torch.serve", "--neigh_ckpt",
         NEIGH, "--gossip_ckpt", GOSSIP, "--device", "cpu", "--tcp",
         f"127.0.0.1:{port}", "--large_threshold", str(g.n_nodes)],
        cwd=REPO, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        for line in proc.stderr:
            if line.startswith("listening on"):
                break
        else:
            pytest.fail(f"the daemon exited {proc.wait()} before listening")
        with socket.create_connection(("127.0.0.1", port), timeout=120) as c:
            rf, wf = c.makefile("r"), c.makefile("w")
            wf.write(json.dumps(request(5, [g], node_counts=True))
                     + "\nquit\n")
            wf.flush()
            reply = json.loads(rf.readline())
    finally:
        proc.kill()
        proc.wait()
    want = svc.count_large_graph(g)
    assert reply["id"] == 5 and reply["refined"]
    np.testing.assert_array_equal(reply["graphlet_counts"],
                                  want.graphlet_counts)
    np.testing.assert_allclose(reply["node_counts"], want.node_counts,
                               rtol=1e-6)
