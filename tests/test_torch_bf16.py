"""The bf16 target tower of desco_tpu_torch against desco_tpu's, on the CPU.

Kernel wrappers (their plain versions: the tensors lie on the CPU) on
bf16 rows against desco_tpu's Pallas kernels in interpret mode on the
same bf16 inputs; both sides accumulate in f32, so forward sums agree far
inside bf16 rounding (rtol 1e-2 / atol 2e-2 as tests/test_pallas_segment.py)
and gradients within 0.05 of each tensor's max, that test's own bound.
Towers, losses, the training stage and the service against desco_tpu's
bf16 paths: desco_tpu on the CPU never runs Pallas, so its bf16 scatter
accumulates in bf16 where the port accumulates in f32, and the two agree
to bf16 rounding only: atol 0.05 in log2(count + 1) space, the bound of
desco_tpu's own bf16 tests (tests/test_models.py::test_bf16_tower_parity)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import desco_tpu.ops.pallas_segment as ps
from desco_tpu.models import neighborhood as jneigh
from desco_tpu.models import shmp_gnn as jshmp
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch import pipeline as tpipe
from desco_tpu_torch.models import neighborhood as tneigh
from desco_tpu_torch.models import shmp_gnn as tshmp
from desco_tpu_torch.ops import cuda_segment as cs
from desco_tpu_torch.ops import segment as tseg
from desco_tpu_torch.pipeline import (
    PipelineConfig, build_query_batch, train_neighborhood_stage)
from desco_tpu_torch.train import loop as tloop
from desco_tpu_torch.train.checkpoint import (
    flatten_params, load_checkpoint, params_from_jax)
from test_torch_cuda import bwd_perm_of, sorted_stream, typed_case
from test_torch_segment import interpret_mode  # noqa: F401 (fixture)
from test_torch_shmp import (  # noqa: F401 (autouse fixture)
    jax_batch, one_torch_thread, target_batch)
from test_torch_train import QUIET, tiny_cfg, tiny_data  # noqa: F401

T = torch.from_numpy
BF = torch.bfloat16


def bf(a):
    return T(a).to(BF)


def jbf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def f32(t):
    return t.detach().float().numpy()


# ------------------------------------------------------- kernel wrappers
@pytest.mark.parametrize("k", [64, 128])
def test_k1_bf16_matches_pallas_interpret(rng, interpret_mode, k):
    msgs, seg = sorted_stream(rng, 300, 960, k)
    ref = np.asarray(ps.pallas_sorted_segment_sum(
        jbf(msgs), jnp.asarray(seg), 300))
    out = cs.sorted_segment_sum(bf(msgs), T(seg), 300,
                                cs.segment_offsets(T(seg), 300))
    assert out.dtype == torch.float32  # f32 accumulate, f32 out
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-2, atol=2e-2)
    # against an f64 sum of the same bf16 rows: f32 accumulation error only
    exact = np.zeros((300, k))
    rows = f32(bf(msgs)).astype(np.float64)
    live = (seg >= 0) & (seg < 300)
    np.add.at(exact, seg[live], rows[live])
    np.testing.assert_allclose(out.numpy(), exact, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_perm", [False, True])
def test_bf16_grads_through_kernel_path(rng, interpret_mode, use_perm):
    """Port of test_pallas_segment.py::test_bf16_grads_through_pallas_path:
    K2 on bf16 x and W, forward and gradients (K3 with a permutation, the
    legacy backward without) against desco_tpu's kernel path in interpret
    mode on the same bf16 inputs, and against its f32 gradients; the
    gradients come back in the primals' dtypes."""
    n, t = 256, 6
    x, src, _, _, keys, w = typed_case(rng, n, t, 64, 64, 1024)
    perm = bwd_perm_of(src, keys, t, n)
    sd, kd = jnp.asarray(src), jnp.asarray(keys)

    def jloss(x_, w_):
        o = ps.fused_typed_transform_aggregate(
            x_, sd, kd, w_, t, n,
            bwd_perm=jnp.asarray(perm) if use_perm else None)
        return 0.5 * jnp.sum(o.astype(jnp.float32) ** 2)

    ref_out = np.asarray(ps.fused_typed_transform_aggregate(
        jbf(x), sd, kd, jbf(w), t, n))
    g32 = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    gbf = jax.grad(jloss, argnums=(0, 1))(jbf(x), jbf(w))

    xs, ws = bf(x).requires_grad_(), bf(w).requires_grad_()
    before = [kern.launches for kern in cs.KERNELS]
    out = cs.fused_typed_transform_aggregate(
        xs, T(src), T(keys), ws, t, n,
        bwd_perm=T(perm) if use_perm else None)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(f32(out), ref_out, rtol=1e-2, atol=2e-2)
    (0.5 * (out ** 2).sum()).backward()
    assert xs.grad.dtype == BF and ws.grad.dtype == BF
    assert [kern.launches for kern in cs.KERNELS] == before  # plain path
    for got, jb, j32 in zip((xs.grad, ws.grad), gbf, g32):
        assert jb.dtype == jnp.bfloat16
        for want in (np.asarray(jb, np.float32), np.asarray(j32)):
            denom = max(np.abs(want).max(), 1e-6)
            assert np.abs(f32(got) - want).max() / denom < 0.05


def test_k3_bf16_plain_sums_in_f32(rng):
    n, t, k = 200, 3, 32
    x, src, dst, typ, keys, _ = typed_case(rng, n, t, 8, k, 900)
    st = cs.typed_streams(T(src), T(keys), t, n, n,
                          T(bwd_perm_of(src, keys, t, n)))
    g = rng.standard_normal((n, k)).astype(np.float32)
    u = cs.typed_cotangent_sums_plain(bf(g), st)
    assert u.dtype == torch.float32
    exact = np.zeros((n * t, k))
    live = typ < t
    np.add.at(exact, (src * t + typ)[live],
              f32(bf(g)).astype(np.float64)[dst[live]])
    np.testing.assert_allclose(u.numpy(), exact, rtol=1e-5, atol=1e-5)


def test_k4_bf16_cotangent_follows_the_primal(rng, interpret_mode):
    """K1 under grad on bf16 messages: the cotangent is bf16, as
    ``sorted_segment_sum_ad``'s (pallas_segment.py:464-469)."""
    n, k = 128, 128
    msgs, seg = sorted_stream(rng, n, 448, k)
    g = rng.standard_normal((n, k)).astype(np.float32)

    def f(m):
        return (ps.sorted_segment_sum_ad(m, jnp.asarray(seg), n)
                * jnp.asarray(g)).sum()

    ref = jax.grad(f)(jbf(msgs))
    assert ref.dtype == jnp.bfloat16
    m = bf(msgs).requires_grad_()
    (cs.sorted_segment_sum(m, T(seg), n, cs.segment_offsets(T(seg), n))
     * T(g)).sum().backward()
    assert m.grad.dtype == BF
    np.testing.assert_array_equal(f32(m.grad), np.asarray(ref, np.float32))
    assert float(m.grad[-64:].abs().max()) == 0.0  # pad keys get zero
    d32 = cs.segment_sum_vjp(T(g), T(seg), n)
    assert d32.dtype == torch.float32
    assert torch.equal(cs.segment_sum_vjp(T(g), T(seg), n, dtype=BF),
                       d32.to(BF))
    with pytest.raises(ValueError, match="f32 or bf16"):
        cs.segment_sum_vjp(T(g), T(seg), n, dtype=torch.float16)


def test_mixed_and_unknown_types_raise(rng):
    x, src, _, _, keys, w = typed_case(rng, 50, 2, 8, 8, 100)
    with pytest.raises(ValueError, match="one type"):
        cs.fused_typed_transform_aggregate(bf(x), T(src), T(keys), T(w),
                                           2, 50)
    with pytest.raises(ValueError, match="bfloat16"):
        cs._require(T(x).double(), "x", cs.ROW_DTYPES, 2)
    with pytest.raises(ValueError, match="dtype"):
        tshmp.SHMPConfig(dtype=torch.float16)


def test_segment_ops_accumulate_bf16_rows_in_f32(rng):
    """``segment_sum`` and ``typed_transform_aggregate`` return the f32
    sums; ``typed_edge_aggregate`` and ``graph_pool_sum`` fold them back
    to bf16 — each the f32 sum of the bf16 rows, rounded once."""
    n, t, h = 150, 6, 16
    x, src, dst, typ, _, w = typed_case(rng, n, t, h, h, 700)
    xb = bf(x)
    agg = tseg.typed_edge_aggregate(xb, T(src), T(dst), T(typ), t)
    assert agg.dtype == BF
    ref = tseg.typed_edge_aggregate(xb.float(), T(src), T(dst), T(typ), t)
    assert torch.equal(agg, ref.to(BF))
    graph = np.sort(rng.integers(0, 9, n)).astype(np.int32)
    pooled = tseg.graph_pool_sum(xb, T(graph), 9)
    assert pooled.dtype == BF
    assert torch.equal(
        pooled, tseg.graph_pool_sum(xb.float(), T(graph), 9).to(BF))
    out = tseg.typed_transform_aggregate(xb, bf(w), T(src), T(dst), T(typ),
                                         t)
    assert out.dtype == torch.float32
    assert tseg.segment_sum(xb, T(graph), 9).dtype == torch.float32


# ---------------------------------------------------------------- towers
def tower_models(layers=4, hidden=16):
    kw = dict(hidden_dim=hidden, output_dim=hidden)
    jt = jshmp.neighborhood_target_config(layer_num=layers, **kw)
    jq = jshmp.query_config(layer_num=2, **kw)
    tt = tshmp.neighborhood_target_config(layer_num=layers, **kw)
    tq = tshmp.query_config(layer_num=2, **kw)
    jparams = jneigh.init_neighborhood_model(jax.random.PRNGKey(0), jt, jq)
    return (jt, jq, jparams), (tt, tq, params_from_jax(_flatten(jparams)))


@pytest.mark.parametrize("agg_mode", ["aggregate_first", "kernel"])
def test_bf16_tower_parity(agg_mode):
    """Port of test_models.py::test_bf16_tower_parity: the bf16 target
    tower against the port's f32 tower AND against desco_tpu's bf16
    tower, in log2(count + 1) space; the head's output is f32."""
    (jt, jq, jp), (tt, tq, tp) = tower_models()
    tt = dataclasses.replace(tt, agg_mode=agg_mode)
    batch = target_batch(seed=4)
    qb = build_query_batch(PipelineConfig(query_sizes=(3,)))
    jb, jqb = jax_batch(batch), jax_batch(qb)
    ref_bf = np.asarray(jneigh.forward_counts(
        jp, dataclasses.replace(jt, dtype=jnp.bfloat16), jq, jb, jqb))
    with torch.inference_mode():
        b, q = batch.to("cpu"), qb.to("cpu")
        p32 = tneigh.forward_counts(tp, tt, tq, b, q)
        pbf = tneigh.forward_counts(
            tp, dataclasses.replace(tt, dtype=BF), tq, b, q)
        emb = tshmp.apply_shmp(tp["target"],
                               dataclasses.replace(tt, dtype=BF), b)
    assert pbf.dtype == torch.float32   # the head stays f32
    assert emb.dtype == BF              # the tower runs in bf16
    assert not torch.equal(pbf, p32)
    m = batch.graph_mask > 0
    np.testing.assert_allclose(pbf.numpy()[m], p32.numpy()[m], atol=0.05)
    np.testing.assert_allclose(pbf.numpy()[m], ref_bf[m], atol=0.05)
    # the padding invariant survives the casts
    with torch.inference_mode():
        core = tshmp.apply_shmp_core(
            tp["target"], dataclasses.replace(tt, dtype=BF), b)
    assert core.dtype == BF
    assert float(core[batch.node_mask == 0].abs().max()) == 0.0


def test_bf16_loss_tracks_f32(tiny_cfg, tiny_data):
    """Port of test_pipeline.py::test_bf16_loss_tracks_f32: the bf16
    training loss tracks the f32 one and desco_tpu's bf16 one, and the
    gradients reaching the f32 masters (and Adam) are f32."""
    from desco_tpu.pipeline import PipelineConfig as JConfig
    from desco_tpu.pipeline import model_configs as j_model_configs
    from test_torch_train import TINY

    train = tiny_data[0]
    qb = build_query_batch(tiny_cfg)
    jt, jq = j_model_configs(JConfig(**{**TINY,
                                        "agg_mode": "aggregate_first"}))
    jparams = jneigh.init_neighborhood_model(jax.random.PRNGKey(0), jt, jq)
    b = train.batches[0]
    jl_bf = float(jneigh.train_loss(
        jparams, dataclasses.replace(jt, dtype=jnp.bfloat16), jq,
        jax_batch(b), jax_batch(qb)))
    tt, tq = tpipe.model_configs(tiny_cfg, "cpu")
    tt_bf = dataclasses.replace(tt, dtype=BF)
    params = params_from_jax(_flatten(jparams)).requires_grad_(True)
    tb, tqb = b.to("cpu", training=True), qb.to("cpu")
    l32 = float(tneigh.train_loss(params, tt, tq, tb, tqb).detach())
    loss = tneigh.train_loss(params, tt_bf, tq, tb, tqb)
    assert loss.dtype == torch.float32
    lbf = float(loss.detach())
    assert abs(lbf - l32) < 0.05 * max(1.0, abs(l32))
    assert abs(lbf - jl_bf) < 0.05 * max(1.0, abs(jl_bf))
    loss.backward()
    grads = [p.grad for p in params.parameters()]
    assert all(g is not None and g.dtype == torch.float32 for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0
    assert all(p.dtype == torch.float32 for p in params.parameters())
    # through the optimizer: Adam's flat f32 buffers take the step
    params.requires_grad_(False)
    opt = tloop.make_adam(params)
    before = opt.flat.clone()
    _, ok = tloop.train_step(
        params, opt, tloop.neighborhood_loss_fn(tt_bf, tq, tqb), tb, 1e-3,
        None)
    assert bool(ok) and opt.grad.dtype == torch.float32
    assert float(opt.grad.abs().max()) > 0
    assert not torch.equal(opt.flat, before)
    # a gradient that is no longer the f32 view of the flat buffer raises
    first = next(params.parameters())
    first.grad = first.grad.clone()
    with pytest.raises(RuntimeError, match="float32 view"):
        opt.step(1e-3)


def test_bf16_training_and_val_cadence(tiny_cfg, tiny_data, tmp_path):
    """Port of test_pipeline.py::test_bf16_training_and_val_cadence:
    ``train_bf16`` still learns, keeps f32 masters and an f32 returned
    config, and ``val_every=3`` evaluates epochs 0, 3 and the last."""
    train, val, _ = tiny_data
    cfg = dataclasses.replace(tiny_cfg, train_bf16=True, val_every=3,
                              neigh_epochs=7)
    res, tgt_cfg, _ = train_neighborhood_stage(
        cfg, train, val, build_query_batch(cfg),
        ckpt_path=str(tmp_path / "bf16"), **QUIET)
    assert res.train_losses[-1] < res.train_losses[0]
    assert tgt_cfg.dtype == torch.float32
    assert all(p.dtype == torch.float32
               for p in res.best_params.parameters())
    assert [i for i, v in enumerate(res.val_losses)
            if np.isfinite(v)] == [0, 3, 6]
    assert np.isfinite(res.best_val)
    # the checkpoint is f32 and loads in desco_tpu
    saved = np.load(tmp_path / "bf16.best.params.npz")
    assert all(saved[k].dtype == np.float32 for k in saved.files)
    best, meta = load_checkpoint(str(tmp_path / "bf16.best"))
    assert meta["config"]["train_bf16"] is True
    from desco_tpu.pipeline import PipelineConfig as JConfig
    from desco_tpu.pipeline import model_configs as j_model_configs
    from desco_tpu.train import checkpoint as jckpt
    from test_torch_train import TINY

    jt, jq = j_model_configs(JConfig(**TINY))
    template = jneigh.init_neighborhood_model(jax.random.PRNGKey(1), jt, jq)
    jparams, _, _ = jckpt.load_checkpoint(str(tmp_path / "bf16.best"),
                                          template)
    flat = flatten_params(best)
    for key, arr in jckpt._flatten(jparams).items():
        assert arr.dtype == np.float32
        np.testing.assert_array_equal(arr, flat[key])


def test_bf16_training_validates_on_f32_tower(tiny_cfg, tiny_data,
                                              monkeypatch):
    """Port of test_pipeline.py::test_bf16_training_validates_on_f32_tower:
    the step's tower config is bf16, the val passes' is f32."""
    train, val, _ = tiny_data
    cfg = dataclasses.replace(tiny_cfg, train_bf16=True, neigh_epochs=1)
    seen = {}
    orig = tloop.train_neighborhood

    def spy(params, tgt_cfg, *a, **kw):
        seen["step_dtype"] = tgt_cfg.dtype
        seen["eval_cfg"] = kw.get("eval_tgt_cfg")
        return orig(params, tgt_cfg, *a, **kw)

    monkeypatch.setattr(tloop, "train_neighborhood", spy)
    train_neighborhood_stage(cfg, train, val, build_query_batch(cfg),
                             **QUIET)
    assert seen["step_dtype"] == BF
    assert seen["eval_cfg"] is not None
    assert seen["eval_cfg"].dtype == torch.float32


# --------------------------------------------------------------- serving
NEIGH, GOSSIP = "release/r4/neigh.best", "release/r4/gossip.best"


def test_serve_bf16_matches_desco_tpu_on_r4():
    """``serve_bf16`` through ``CountingService`` on release/r4 against
    desco_tpu's. Without tail verification (the two packages would rank
    different rows) counts compare in log2(count + 1) space: 8 layers of
    bf16 rounding at width 64, with desco_tpu's scatter accumulating in
    bf16 — atol 0.15 (0.041 against desco_tpu's bf16 service and 0.075
    against the port's own f32 service on these graphs). Everything past
    the count head is f32 on both sides."""
    from desco_tpu.data.synthetic import generate_synthetic
    from desco_tpu.serving import CountingService as JService
    from desco_tpu_torch.graph import Graph
    from desco_tpu_torch.serving import CountingService

    jgraphs = generate_synthetic(4, min_size=10, max_size=24, seed=5)
    graphs = [Graph(g.n_nodes, g.edges.copy()) for g in jgraphs]
    over = {"serve_bf16": True, "verify_budget": 0.0}
    ref = JService(NEIGH, GOSSIP, config_overrides=over).count(jgraphs)
    svc = CountingService(NEIGH, GOSSIP, config_overrides=over, device="cpu")
    assert svc.cfg.serve_bf16 and svc.tgt_cfg.dtype == torch.float32
    ours = svc.count(graphs)
    f32_res = CountingService(
        NEIGH, GOSSIP, config_overrides={"verify_budget": 0.0},
        device="cpu").count(graphs)
    assert ours.refined and ours.neighborhood_counts.dtype == np.float32
    assert np.isfinite(ours.node_counts).all()
    assert (ours.graphlet_counts >= 0).all()

    def log2p(c):
        return np.log2(np.maximum(c, 0.0) + 1.0)

    assert not np.array_equal(ours.neighborhood_counts,
                              f32_res.neighborhood_counts)
    np.testing.assert_allclose(log2p(ours.neighborhood_counts),
                               log2p(ref.neighborhood_counts), atol=0.15)
    np.testing.assert_allclose(log2p(ours.neighborhood_counts),
                               log2p(f32_res.neighborhood_counts), atol=0.15)
    np.testing.assert_allclose(log2p(ours.node_counts),
                               log2p(ref.node_counts), atol=0.15)


def test_bf16_flags_reach_the_config(monkeypatch):
    from desco_tpu_torch import serve
    from desco_tpu_torch.config import build_parser, to_pipeline_config

    cfg = to_pipeline_config(build_parser().parse_args(
        ["--serve_bf16", "--neigh_bf16_train"]))
    assert cfg.serve_bf16 and cfg.train_bf16
    cfg = to_pipeline_config(build_parser().parse_args([]))
    assert not cfg.serve_bf16 and not cfg.train_bf16
    seen = {}

    class Spy:
        def __init__(self, *a, **kw):
            seen.update(kw)

    import desco_tpu_torch.serving as serving

    monkeypatch.setattr(serving, "CountingService", Spy)
    monkeypatch.setattr(serve, "serve_lines", lambda *a: None)
    assert serve.main(["--neigh_ckpt", NEIGH, "--bf16", "--device",
                       "cpu"]) == 0
    assert seen["config_overrides"] == {"serve_bf16": True}
    assert seen["device"] == "cpu"
    assert serve.main(["--neigh_ckpt", NEIGH, "--device", "cpu"]) == 0
    assert seen["config_overrides"] is None
