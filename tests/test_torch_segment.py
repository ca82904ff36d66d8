"""desco_tpu_torch segment ops and kernel wrappers against desco_tpu.

The port's plain K1/K2 (what the wrappers run on CPU tensors) are held
against desco_tpu's Pallas kernels run in interpret mode — bf16 messages
on that side, so tolerances are bf16-level (rtol 1e-2 / atol 2e-2, as
tests/test_pallas_segment.py) — and against desco_tpu's XLA float32
path, where only the summation order differs (rtol 1e-5). The CUDA
kernels themselves run only on a GPU: tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import desco_tpu.ops.pallas_segment as ps
from desco_tpu.ops import segment as jseg
from desco_tpu_torch.ops import cuda_segment as cs
from desco_tpu_torch.ops import segment as tseg
from test_torch_cuda import sorted_stream, typed_case
from test_torch_shmp import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(kernel, **kw):
        kw["interpret"] = True
        return orig(kernel, **kw)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)


T = torch.from_numpy


@pytest.mark.parametrize("k", [64, 128])
def test_k1_plain_matches_pallas_interpret(rng, interpret_mode, k):
    msgs, seg = sorted_stream(rng, 300, 960, k)
    ref = np.asarray(ps.pallas_sorted_segment_sum(
        jnp.asarray(msgs), jnp.asarray(seg), 300))
    out = cs.sorted_segment_sum(T(msgs), T(seg), 300).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=2e-2)


def test_k1_plain_matches_xla_f32(rng):
    msgs, seg = sorted_stream(rng, 500, 3000, 48, neg=5)
    ref = np.asarray(jseg.segment_sum(jnp.asarray(msgs), jnp.asarray(seg),
                                      500, indices_are_sorted=True))
    out = cs.sorted_segment_sum(T(msgs), T(seg), 500).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_k2_plain_matches_pallas_interpret(rng, interpret_mode):
    n, t = 256, 6
    x, src, _, _, keys, w = typed_case(rng, n, t, 64, 64, 1024)
    ref = np.asarray(ps.fused_typed_transform_aggregate(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(keys),
        jnp.asarray(w), t, n))
    out = cs.fused_typed_transform_aggregate(
        T(x), T(src), T(keys), T(w), t, n).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("t,k", [(6, 64), (2, 32), (3, 128)])
def test_k2_plain_matches_xla_f32(rng, t, k):
    n = 200
    x, src, dst, typ, keys, w = typed_case(rng, n, t, 32, k, 900)
    ref = np.asarray(jseg.typed_transform_aggregate(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(typ), t))
    out = cs.fused_typed_transform_aggregate(
        T(x), T(src), T(keys), T(w), t, n).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_segment_ops_match_xla(rng):
    n, t, h = 150, 6, 16
    x, src, dst, typ, _, _ = typed_case(rng, n, t, h, h, 700)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    np.testing.assert_allclose(
        tseg.typed_edge_aggregate(T(x), T(src), T(dst), T(typ), t).numpy(),
        np.asarray(jseg.typed_edge_aggregate(j(x), j(src), j(dst), j(typ),
                                             t)),
        rtol=1e-5, atol=1e-5)
    w = (rng.standard_normal((t, h, 24)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        tseg.typed_transform_aggregate(T(x), T(w), T(src), T(dst), T(typ),
                                       t).numpy(),
        np.asarray(jseg.typed_transform_aggregate(j(x), j(w), j(src), j(dst),
                                                  j(typ), t)),
        rtol=1e-5, atol=1e-5)
    graph = np.sort(rng.integers(0, 9, n)).astype(np.int32)
    graph[-5:] = 9  # pad nodes -> slot G
    np.testing.assert_allclose(
        tseg.graph_pool_sum(T(x), T(graph), 9).numpy(),
        np.asarray(jseg.graph_pool_sum(j(x), j(graph), 9)),
        rtol=1e-5, atol=1e-5)
    ids = rng.integers(-3, n + 3, 400).astype(np.int32)  # unsorted, OOR
    data = rng.standard_normal((400, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tseg.segment_sum(T(data), T(ids), n).numpy(),
        np.asarray(jseg.segment_sum(j(data), j(ids), n)),
        rtol=1e-5, atol=1e-5)


def test_wrappers_take_plain_path_only_on_cpu(rng):
    msgs, seg = sorted_stream(rng, 40, 200, 8)
    before = [kern.launches for kern in cs.KERNELS]
    cs.sorted_segment_sum(T(msgs), T(seg), 40)
    x, src, _, _, keys, w = typed_case(rng, 50, 2, 8, 8, 100)
    cs.fused_typed_transform_aggregate(T(x), T(src), T(keys), T(w), 2, 50)
    # the plain path is no kernel launch
    assert [kern.launches for kern in cs.KERNELS] == before
    # any tensor off the CPU must reach the kernel or raise: a meta
    # tensor is neither CPU nor CUDA
    meta = T(msgs).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        cs.sorted_segment_sum(meta, T(seg), 40)
    with pytest.raises(ValueError, match="CUDA"):
        cs.fused_typed_transform_aggregate(
            T(x).to("meta"), T(src), T(keys), T(w), 2, 50)


def test_default_agg_mode_and_config_mapping():
    from desco_tpu_torch.pipeline import PipelineConfig, model_configs

    assert cs.default_agg_mode("cuda") == "kernel"
    assert cs.default_agg_mode(torch.device("cuda", 0)) == "kernel"
    assert cs.default_agg_mode("cpu") == "aggregate_first"
    for mode in ("auto", "pallas"):
        cfg = PipelineConfig(agg_mode=mode)
        assert model_configs(cfg, "cuda")[0].agg_mode == "kernel"
        assert model_configs(cfg, "cpu")[0].agg_mode == "aggregate_first"
        # the query tower keeps aggregate_first (K1, then one matmul, on
        # the card), as desco_tpu's query_config keeps its default
        assert model_configs(cfg, "cuda")[1].agg_mode == "aggregate_first"
    # desco_tpu's XLA transform-then-reduce modes compute what K2 computes
    for mode in ("transform_first", "cumsum"):
        assert model_configs(PipelineConfig(agg_mode=mode),
                             "cpu")[0].agg_mode == "kernel"


@pytest.mark.parametrize("n_nodes", [150, 120, 170])
def test_k2_plain_output_rows(rng, n_nodes):
    """n_nodes below the table's rows drops the later destinations and
    above it pads zero rows, as segment_sum over dst = key // T does."""
    n, t = 150, 3
    x, src, dst, typ, keys, w = typed_case(rng, n, t, 8, 8, 500)
    ref = np.asarray(jseg.segment_sum(
        jnp.asarray(np.einsum("eh,ehk->ek", x[src], w[np.minimum(typ, t - 1)])
                    * (typ < t)[:, None]),
        jnp.asarray(dst), n_nodes))
    out = cs.fused_typed_transform_aggregate(
        T(x), T(src), T(keys), T(w), t, n_nodes).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
