"""``python -m desco_tpu_torch.bench`` and the K5 probe's plain variants,
on the CPU.

``build_workload`` is held against the invariants of the root
``bench.build_workload`` (the two draw their graphs from different
generators, so structure is compared, not values); the bytes model
against a hand count; the JSON line's keys on ``--device cpu`` at a
shrunk workload. The probe's variants run their plain versions here: a
three-segment hand example fixes what each computes."""

import json

import numpy as np
import pytest
import torch

from desco_tpu_torch import bench as tbench
from desco_tpu_torch.ops import cuda_segment as cs
from desco_tpu_torch.tools import segsum_inner_ablation as probe
from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)

T = torch.from_numpy


# ----------------------------------------------------------------- bench
@pytest.fixture(scope="module")
def workloads():
    import bench as jbench  # the repo's root bench.py

    return (tbench.build_workload(n_graphs=6, seed=0),
            jbench.build_workload(n_graphs=6, seed=0))


def _structure(batch, qb):
    """What ``bench.build_workload`` guarantees of its batch, whatever
    the graphs: (name, dtype, ndim) of every field and the invariants."""
    fields = {n: np.asarray(getattr(batch, n)) for n in (
        "x", "node_type", "node_graph", "node_mask", "edge_src", "edge_dst",
        "edge_type", "graph_mask", "edge_bwd_perm")}
    n_cap, e_cap = fields["x"].shape[0], fields["edge_src"].shape[0]
    g_cap = fields["graph_mask"].shape[0]
    assert n_cap % 128 == 0 and e_cap % 512 == 0
    # auto_capacities(g_cap=512): 512 slots, or all the neighborhoods
    assert g_cap == 512 or g_cap == fields["graph_mask"].sum() < 512
    assert fields["x"].shape == (n_cap, 1)
    live_n = fields["node_mask"] > 0
    assert fields["node_mask"][-1] == 0          # the pad node
    assert (fields["node_graph"][~live_n] == g_cap).all()
    assert (np.diff(fields["node_graph"]) >= 0).all()
    assert fields["graph_mask"].sum() == fields["node_graph"][live_n].max() + 1
    # one canonical node (type 1) per neighborhood
    assert (fields["node_type"][live_n] == 1).sum() == fields[
        "graph_mask"].sum()
    # (dst, type)-sorted stream, padding (type 63, the pad node) last
    keys = fields["edge_dst"].astype(np.int64) * 6 + fields["edge_type"]
    assert (np.diff(keys) >= 0).all()
    pad = fields["edge_type"] == 63
    assert (fields["edge_type"][~pad] < 6).all()
    assert (fields["edge_src"][pad] == n_cap - 1).all()
    assert (fields["edge_dst"][pad] == n_cap - 1).all()
    assert not pad[:int((~pad).sum())].any()
    assert live_n[fields["edge_src"][~pad]].all()
    # the backward permutation: slots in (src, type) order
    perm = fields["edge_bwd_perm"]
    assert sorted(perm.tolist()) == list(range(e_cap))
    skey = (fields["edge_src"].astype(np.int64) * 64
            + fields["edge_type"])[perm]
    assert (np.diff(skey) >= 0).all()
    assert getattr(batch, "y", None) is None
    assert int(np.asarray(qb.graph_mask).sum()) == 29  # the 29 queries
    assert np.asarray(qb.edge_type).max() == 63 or \
        np.asarray(qb.edge_type).max() < 2
    return {n: (str(a.dtype), a.ndim) for n, a in fields.items()}


def test_build_workload_has_bench_py_structure(workloads):
    (tb, tqb), (jb, jqb) = workloads
    ours, ref = _structure(tb, tqb), _structure(jb, jqb)
    assert ours == ref
    # the query batch does not depend on the graphs: equal field by field
    for name in ("x", "node_type", "node_graph", "node_mask", "edge_src",
                 "edge_dst", "edge_type", "graph_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(tqb, name)),
                                      np.asarray(getattr(jqb, name)))
    # graphs of 30-120 nodes, as bench.py's: neighborhoods of depth 4
    assert 30 * 6 <= float(np.asarray(tb.graph_mask).sum())


def test_build_workload_on_a_device_keeps_the_permutation():
    batch, qb = tbench.build_workload(n_graphs=2, device="cpu")
    assert isinstance(batch.x, torch.Tensor)
    assert batch.edge_bwd_perm.dtype == torch.int32
    assert batch.y is None and isinstance(qb.x, torch.Tensor)
    again, _ = tbench.build_workload(n_graphs=2)
    np.testing.assert_array_equal(batch.edge_src.numpy(), again.edge_src)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_roofline_bytes_matches_a_hand_count(itemsize):
    """3 nodes, 8 edge slots of which 5 live, 2 types, width 4, 1 layer."""
    n, e_cap, e_live, t, h = 3, 8, 5, 2, 4
    by_hand = (
        e_live * 4                     # the live edges' sources
        + e_live * h * itemsize        # one x row per live edge
        + n * t * 4                    # the (node, type) run offsets
        + n * h * 4                    # K2's f32 output write
        + n * h * 4 + n * h * itemsize  # update linear reads
        + n * h * itemsize)            # update linear write
    assert tbench._roofline_bytes(n, e_cap, e_live, t, h, 1,
                                  itemsize) == by_hand
    assert tbench._roofline_bytes(n, e_cap, e_live, t, h, 8,
                                  itemsize) == 8 * by_hand
    assert by_hand == {4: 20 + 80 + 24 + 48 + 96 + 48,
                       2: 20 + 40 + 24 + 48 + 72 + 24}[itemsize]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bench_line_on_the_cpu(dtype, monkeypatch, capsys, tmp_path):
    """The JSON line carries bench.py's keys; a CPU line names the CPU as
    its device and neither reads nor writes the baseline file."""
    monkeypatch.setattr(tbench, "N_GRAPHS", 2)
    monkeypatch.setattr(tbench, "MIN_WINDOW_S", 0.01)
    monkeypatch.setattr(tbench, "MIN_ITERS", 1)
    monkeypatch.setattr(tbench, "MIN_TRAIN_ITERS", 1)
    baseline = tmp_path / "bench_baseline.json"
    monkeypatch.setattr(tbench, "BASELINE_PATH", str(baseline))
    assert tbench.main(["--device", "cpu", "--dtype", dtype]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    line = json.loads(lines[0])
    bench_py_keys = {"metric", "value", "unit", "vs_baseline", "graphs_per_s",
                     "bytes_per_edge_layer", "sol_fraction",
                     "hbm_gbps_assumed", "train_edges_per_s", "train_step_ms"}
    assert bench_py_keys | {"dtype", "device", "launches"} <= set(line)
    assert line["metric"] == "shmp_neighborhood_forward_edges_per_s_per_chip"
    assert line["unit"] == "edges/s" and line["dtype"] == dtype
    assert line["device"] == "cpu" and line["vs_baseline"] == 1.0
    assert line["hbm_gbps_assumed"] == 3350.0
    assert line["value"] > 0 and line["train_step_ms"] > 0
    assert 0 < line["sol_fraction"] <= 1.05
    # the CPU runs the plain versions: no kernel launch
    assert set(line["launches"]) == {k.__name__ for k in cs.KERNELS}
    assert not any(line["launches"].values())
    assert not baseline.exists()
    # the bytes per edge follow the tower's element size
    assert line["bytes_per_edge_layer"] == pytest.approx(
        tbench._roofline_bytes(line["n_cap"], line["e_cap"],
                               line["valid_edges"], 6, 64, 8,
                               4 if dtype == "float32" else 2)
        / 8 / line["valid_edges"], abs=0.05)


def test_bench_wants_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbench.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.main([])
    with pytest.raises(SystemExit):
        tbench.main(["--dtype", "float16"])


# ------------------------------------------------------------- K5, plain
# three segments over eight rows of four columns; E = 8, n = 3: run = 3
HAND = np.array([[1, 2, 3, 4], [0.5, 0, 0, 1], [2, 2, 2, 2], [1, 1, 1, 1],
                 [4, 0, 0, 0], [0, 0, 0, 8], [3, 3, 3, 3], [1, 0, 1, 0]],
                np.float32)
HAND_SEG = np.array([0, 0, 0, 2, 2, 2, 2, 2 ** 30], np.int32)


def _bits(x):
    """The bf16 bit pattern of each value, as an integer."""
    return (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)


@pytest.mark.parametrize("name", ["full", "nooffs", "noacc", "stream"])
def test_probe_variant_on_the_hand_example(name):
    msgs, seg = T(HAND).to(torch.bfloat16), T(HAND_SEG)
    before = probe.VARIANTS[name].launches
    out = probe.VARIANTS[name](msgs, seg, 3)
    assert probe.VARIANTS[name].launches == before  # the plain path
    if name == "full":  # the segment-sum; the padding row is dropped
        want = np.stack([HAND[:3].sum(0), np.zeros(4), HAND[3:7].sum(0)])
        assert torch.equal(out, cs.sorted_segment_sum(
            msgs, seg, 3, cs.segment_offsets(seg, 3)))
    elif name == "nooffs":  # fixed runs of 3 rows, ids ignored
        want = np.stack([HAND[:3].sum(0), HAND[3:6].sum(0), HAND[6:].sum(0)])
    elif name == "noacc":   # OR of the runs' bf16 bit patterns
        want = np.stack([np.bitwise_or.reduce(_bits(HAND[lo:lo + 3]), 0)
                         for lo in (0, 3, 6)]).astype(np.float32)
    else:                   # zeros, and the OR of all 32-bit words
        out, check = out
        want = np.zeros((3, 4), np.float32)
        b = _bits(HAND)
        words = (b[:, 0::2] | (b[:, 1::2] << 16)).ravel()
        assert check.dtype == torch.int32 and tuple(check.shape) == (1,)
        assert int(check) & 0xFFFFFFFF == int(np.bitwise_or.reduce(words))
    assert out.dtype == torch.float32 and tuple(out.shape) == (3, 4)
    np.testing.assert_array_equal(out.numpy(), want)


def test_probe_full_equals_segment_sum(rng):
    from desco_tpu_torch.ops.segment import segment_sum
    from test_torch_cuda import sorted_stream

    msgs, seg = sorted_stream(rng, 90, 700, 16, neg=2)
    m = T(msgs).to(torch.bfloat16)
    assert torch.equal(probe.probe_full(m, T(seg), 90),
                       segment_sum(m, T(seg), 90))
    # a run that does not divide the stream: the last warps run dry
    out = probe.probe_nooffs(m, T(seg), 100)  # run = 8, 766 rows
    np.testing.assert_allclose(
        out[95].numpy(), m[760:766].float().sum(0).numpy(), rtol=1e-6)
    assert float(out[96:].abs().max()) == 0.0
    assert float(probe.probe_noacc(m, T(seg), 100)[96:].abs().max()) == 0.0


def test_probe_wrappers_take_the_plain_path_only_on_cpu():
    msgs, seg = T(HAND).to(torch.bfloat16), T(HAND_SEG)
    for fn in probe.VARIANTS.values():
        with pytest.raises(ValueError, match="CUDA"):
            fn(msgs.to("meta"), seg, 3)
    assert set(probe.PLAIN) == set(probe.VARIANTS) == {
        "full", "nooffs", "noacc", "stream"}
