"""The operation and byte counters against shapes worked out by hand, and
the trace arithmetic (busy union, idle gaps, span attribution)."""

import numpy as np
import pytest

from h100bench.lib import flops as fl
from h100bench.lib import trace as tr

PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12,
         "tf32_flops_per_s": 495e12}
CFG = {"neigh_hidden_dim": 64, "neigh_layer_num": 8, "neigh_input_dim": 1,
       "conv_type": "SAGE", "gossip_hidden_dim": 64, "gossip_layer_num": 2}


def test_batch_shape_counts_live_rows_and_runs():
    # a triangle (0, 1, 2) and a pad slot: directed edges sorted by
    # (dst, type); two padding edges of type 63
    s = fl.batch_shape(node_mask=[1, 1, 1, 0], graph_mask=[1, 0],
                       edge_dst=[0, 0, 1, 1, 2, 2, 3, 3],
                       edge_type=[0, 4, 0, 2, 0, 0, 63, 63], n_types=6)
    assert s == {"n": 3, "g": 1, "e": 6, "runs": 5}


def test_sage_tower_flops_by_hand():
    s = {"n": 10, "e": 20, "g": 2, "runs": 12}
    h, L, p = 64, 8, 576
    per_layer = 20 * h + 2 * 12 * h * h + 2 * 10 * 2 * h * h
    want = (2 * 10 * 1 * h + L * per_layer + 10 * p + 2 * 2 * p * p
            + 2 * 2 * (p * h + h * h + h * 256 + 256 * h))
    assert fl.tower_flops(s, CFG, 6) == want


def test_gat_tower_flops_by_hand():
    s = {"n": 10, "e": 20, "g": 2, "runs": 12}
    h, L, p, t = 64, 8, 576, 6
    per_layer = (2 * 10 * t * h * h + 4 * 10 * t * h + 20 * (2 * h + 4)
                 + 10 * t * (2 * h + 4) + 10 * t * h)
    want = (2 * 10 * h + L * per_layer + 10 * p + 2 * 2 * p * p
            + 2 * 2 * (p * h + h * h + h * 256 + 256 * h))
    assert fl.tower_flops(s, dict(CFG, conv_type="GAT"), t) == want


def test_head_and_gossip_flops_by_hand():
    h = 64
    assert fl.head_flops(3, 29, h) == (2 * 32 * h * 4 * h + 3 * 29 * 4 * h
                                       + 2 * 3 * 29 * 4 * h)
    s = {"n": 5, "e": 8}
    per = (2 * 5 * 64 + (2 * 8 * 128 + 2 * 5 * 128 * 64
                         + 2 * 5 * 192 * 64)
           + (2 * 8 * 64 + 2 * 5 * 64 * 64 + 2 * 5 * 128 * 64)
           + 2 * 5 * (256 * 64 + 64 * 64 + 64 * 256 + 256))
    assert fl.gossip_flops(s, CFG, 29) == per * 29


def test_query_shape_and_tree_steps():
    q = fl.query_shape()
    assert q["n"] == 2 * 3 + 6 * 4 + 21 * 5 and q["g"] == 29
    assert q["e"] == 320 and q["runs"] == 147
    # a pass per tree edge and rooting of every distinct spanning tree:
    # at most every query's own (2 * 6 + 6 * 12 + 21 * 20 = 504)
    assert fl.tree_steps() == 322


def test_bounds_least_time_by_hand():
    s = {"n": 1000, "e": 4000, "g": 40}
    moved = 4000 * 8 + 1000 * 12 + 40 * 29 * 4
    ops = 322 * 5000
    want = max(moved / 3.35e12, ops / 67e12)
    assert abs(fl.bounds_least_s(s, 29, 322, PEAKS) - want) < 1e-18


def test_aggregation_least_time_counts_the_kernels():
    s = {"n": 100, "e": 400, "g": 4, "runs": 250}
    h, t, p = 64, 6, 576
    fwd = (100 * h + t * h * h) * 4 + 400 * 4 + 601 * 4 + 100 * h * 4
    bwd = (2 * 100 * h + t * h * h) * 4 + 400 * 4 + 601 * 4 \
        + (100 * h + t * h * h) * 4
    one = (max(fwd / 3.35e12, 400 * h / 67e12, 6 * 250 * h * h / 495e12)
           + max(bwd / 3.35e12, 400 * h / 67e12,
                 12 * 250 * h * h / 495e12))
    pool = 100 * p * 4 + 5 * 4 + 4 * p * 4
    want = 8 * one + max(pool / 3.35e12, 100 * p / 67e12) + pool / 3.35e12
    got = fl.aggregation_least_s(s, CFG, t, True, PEAKS)
    assert abs(got - want) < 1e-15


def test_union_and_idle_gaps():
    s = np.array([0, 5, 20], np.int64)
    e = np.array([10, 15, 25], np.int64)
    assert tr.union_ns(s, e) == 20
    assert tr.union_ns(s, e, 3, 22) == 14
    trace = tr.DeviceTrace(["a", "b", "a"], s, e)
    spans = [tr.Span("pack", 1, 15, 20, {}), tr.Span("step", 1, 0, 12, {})]
    bd = tr.breakdown(trace, spans, 0, 30)
    assert bd["device_ops"][0] == ["a", pytest.approx(15e-9)]
    assert dict(bd["idle_gaps"]) == pytest.approx(
        {"pack": 5e-9, "between spans": 5e-9})
    assert tr.span_mask(trace, spans).tolist() == [True, True, False]
