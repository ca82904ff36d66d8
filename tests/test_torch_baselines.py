"""desco_tpu_torch's baselines against desco_tpu's: the SHMP tower's
per-node output, DIAMNet (every memory initialisation, forward and
gradients; node positions and sequences; the whole-graph pipeline and
its loss) and the layouts of both baselines' weights; LRP, the
query-mining utilities and the two baseline drivers are in
tests/test_torch_baselines_lrp.py. Mirrors tests/test_diamnet.py.

Same inputs (numpy, seeded) and weights (desco_tpu's init carried over
with ``params_from_jax``; DIAMNet's zero-initialised output layer is
drawn at random so that every weight gets a gradient), float32 on both
sides unless a test says float64. Tolerances: host arrays and mined
queries equal; values rtol 1e-4, atol 1e-5; gradients within 1e-4 of each
tensor's scale (the bound of chip_smoke.py's gradient checks), DIAMNet's
memory variants within 1e-9 in float64, the SHMP tower alone at
tests/test_torch_grad.py's rtol 1e-4, atol 1e-6 of the scale. Sizes are
small: hidden 16, 2 layers, graphs of 5-14 nodes, sequences of at most
12."""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import random_graph
from desco_tpu.batch.build import query_sample as j_query_sample
from desco_tpu.batch.packed import auto_capacities as j_auto_capacities
from desco_tpu.batch.packed import pack_samples as j_pack_samples
from desco_tpu.models import baseline_diamnet as jbd
from desco_tpu.models import diamnet as jdn
from desco_tpu.models import lrp as jlrp
from desco_tpu.models import shmp_gnn as jshmp
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch.batch.build import query_sample
from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
from desco_tpu_torch.graph import Graph
from desco_tpu_torch.models import baseline_diamnet as tbd
from desco_tpu_torch.models import diamnet as tdn
from desco_tpu_torch.models import lrp as tlrp
from desco_tpu_torch.models import shmp_gnn as tshmp
from desco_tpu_torch.train.checkpoint import (
    flatten_params, jax_keys, params_from_jax)

from test_torch_grad import assert_grads_match
from test_torch_shmp import jax_batch, one_torch_thread  # noqa: F401

T = torch.from_numpy
H = 16
MEM_INITS = ("mean", "sum", "max", "attn", "lstm", "circular_mean",
             "circular_sum", "circular_max", "circular_attn",
             "circular_lstm")


def assert_tree_grads_match(tp, jgrads, min_nonzero, zero_suffix=None,
                            tol=1e-4):
    """Every weight's gradient (the keys of ``jax_keys``: the baselines'
    trees hold bare arrays named ``w`` and ``b``) within ``tol`` of the
    tensor's scale (its largest magnitude). Tensors ending in
    ``zero_suffix`` have a gradient of exactly 0 in both packages
    (DIAMNet's key layer norm bias ``ln_k/1``: a bias added to every key
    shifts each query's logits by one constant, which the softmax
    cancels): their rounding noise must stay under ``tol`` / 100 of the
    tree's largest gradient on both sides."""
    keys = jax_keys(tp)
    got = {keys[n]: (p.grad if p.grad is not None
                     else torch.zeros_like(p)).numpy()
           for n, p in tp.named_parameters()}
    want = _flatten(jgrads)
    assert set(got) == set(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    nonzero = 0
    for key, d in want.items():
        if zero_suffix and key.endswith(zero_suffix):
            assert max(np.abs(d).max(), np.abs(got[key]).max()) <= \
                tol * 1e-2 * top, key
            continue
        scale = float(np.abs(d).max())
        nonzero += scale > 0
        err = float(np.abs(got[key] - d).max())
        assert err <= tol * scale, (key, err, scale)
    assert nonzero >= min_nonzero


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-5)


def graph_pair(seed, n_graphs=6, sizes=(5, 14), p=0.35):
    rng = np.random.default_rng(seed)
    jg = [random_graph(rng, int(rng.integers(*sizes)), p)
          for _ in range(n_graphs)]
    return jg, [Graph(g.n_nodes, g.edges.copy()) for g in jg]


def whole_graph_batches(seed, g_cap=8):
    """The same whole-graph batch (untyped samples, as the baselines pack
    them) and query batch in both packages, with made-up counts and
    random node inputs (the drivers' inputs are zeros, which leaves the
    query nodes nearly alike and the pattern attention's gradients at
    cancellation noise)."""
    jg, tg = graph_pair(seed)
    rng = np.random.default_rng(seed + 100)
    ys = rng.integers(0, 50, (len(tg), 4)).astype(np.float32)
    ts = [query_sample(g, use_tconv=False) for g in tg]
    js = [j_query_sample(g, use_tconv=False) for g in jg]
    for s, t, y in zip(js, ts, ys):
        s.y = t.y = y
        s.x = t.x = rng.standard_normal(t.x.shape).astype(np.float32)
    (tb,) = pack_samples(ts, *auto_capacities(ts, g_cap=g_cap), n_queries=4)
    (jb,) = j_pack_samples(js, *j_auto_capacities(js, g_cap=g_cap),
                           n_queries=4)
    qg = [Graph(3, np.array([[0, 1], [1, 2]])),
          Graph(3, np.array([[0, 1], [1, 2], [0, 2]])),
          Graph(4, np.array([[0, 1], [1, 2], [2, 3]])),
          Graph(4, np.array([[0, 1], [0, 2], [0, 3]]))]
    qs = [query_sample(q, use_tconv=False,
                       x=rng.standard_normal((q.n_nodes, 1))) for q in qg]
    (qb,) = pack_samples(qs, *auto_capacities(qs, g_cap=4))
    return tb, jb, qb


# ------------------------------------------------------- per-node output
@pytest.mark.parametrize("agg_mode", ["aggregate_first", "kernel"])
def test_per_node_output_matches_desco_tpu(agg_mode):
    """The tower without pooling: [N, out] through ``post``, padding rows
    zero; value and gradients of a weighted sum."""
    tb, jb, _ = whole_graph_batches(1)
    jcfg = jbd.diamnet_tower_config(H, 2)
    tcfg = tbd.diamnet_tower_config(H, 2, agg_mode=agg_mode)
    assert tcfg.per_node_output and not tcfg.use_anchor
    jp = jshmp.init_shmp(jax.random.PRNGKey(2), jcfg)
    tp = params_from_jax(_flatten(jp))
    wgt = np.random.default_rng(0).standard_normal(
        (tb.n_cap, H)).astype(np.float32)
    want, jgrads = jax.jit(jax.value_and_grad(lambda p: (
        jshmp.apply_shmp(p, jcfg, jax_batch(tb)) * wgt).sum()))(jp)
    out = tshmp.apply_shmp(tp, tcfg, tb.to("cpu", training=True))
    assert tuple(out.shape) == (tb.n_cap, H)
    assert not out[np.asarray(tb.node_mask) == 0].any()
    close(out.detach(), jshmp.apply_shmp(jp, jcfg, jax_batch(tb)))
    (out * T(wgt)).sum().backward()
    assert_grads_match(tp, jgrads, min_nonzero=8)


def test_node_positions_and_sequences_match():
    tb, jb, _ = whole_graph_batches(2)
    pos = tbd.node_positions(tb)
    np.testing.assert_array_equal(pos, jbd.node_positions(jb))
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((tb.n_cap, H)).astype(np.float32)
    seq_len = int(np.bincount(tb.node_graph[tb.node_mask > 0]).max())
    got = tbd.to_sequences(T(emb), tb.to("cpu"), T(pos), seq_len)
    want = jbd.to_sequences(jnp.asarray(emb), jax_batch(tb),
                            jnp.asarray(pos), seq_len)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -------------------------------------------------------------- DIAMNet
def diamnet_pair(mem_init, seed=0):
    cfg_kw = dict(hidden_dim=H, pattern_dim=H, graph_dim=H, num_heads=4,
                  mem_len=4, mem_init=mem_init)
    jcfg, tcfg = jdn.DIAMNetConfig(**cfg_kw), tdn.DIAMNetConfig(**cfg_kw)
    jp = jdn.init_diamnet(jax.random.PRNGKey(seed), jcfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed + 50))
    jp["pred2"] = (jax.random.normal(k1, jp["pred2"][0].shape) * 0.3,
                   jax.random.normal(k2, jp["pred2"][1].shape) * 0.3)
    return jcfg, tcfg, jp, params_from_jax(_flatten(jp))


def test_diamnet_init_layout_matches_desco_tpu():
    """Fresh port weights have desco_tpu's keys and shapes for every
    variant and for both baselines' trees, so checkpoints interchange."""
    for mem_init in MEM_INITS:
        jcfg, tcfg, jp, _ = diamnet_pair(mem_init)
        mine = flatten_params(tdn.init_diamnet(tcfg,
                                               torch.Generator().manual_seed(0)))
        want = _flatten(jp)
        assert {k: v.shape for k, v in mine.items()} == \
            {k: v.shape for k, v in want.items()}
    tower = tbd.diamnet_tower_config(H, 2)
    jt = jbd.diamnet_tower_config(H, 2)
    dn_kw = dict(hidden_dim=H, pattern_dim=H, graph_dim=H)
    mine = flatten_params(tbd.init_diamnet_pipeline(
        tower, tdn.DIAMNetConfig(**dn_kw)))
    want = _flatten(jbd.init_diamnet_pipeline(
        jax.random.PRNGKey(0), jt, jdn.DIAMNetConfig(**dn_kw)))
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in want.items()}
    lcfg = dict(hid_dim=H, num_layers=2, num_tasks=5)
    mine = flatten_params(tlrp.init_lrp(tlrp.LRPConfig(**lcfg)))
    want = _flatten(jlrp.init_lrp(jax.random.PRNGKey(0),
                                  jlrp.LRPConfig(**lcfg)))
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in want.items()}
    with pytest.raises(ValueError, match="mem_init"):
        tdn.DIAMNetConfig(mem_init="median")


@pytest.mark.parametrize("mem_init", MEM_INITS)
def test_diamnet_mem_init_forward_and_gradients(mem_init):
    """apply_diamnet for each memory initialisation, on graphs shorter
    than, as long as and longer than the memory (lengths 2, 4, 5, 7 and
    12 of 12 slots): the f32 prediction, and every weight's and input's
    gradient in float64 on both sides (desco_tpu under
    ``jax.enable_x64``), within 1e-9 of each tensor's scale — in f32 the
    attention blocks' gradients are sums of terms up to 1e3 times larger
    that cancel, and their rounding noise reaches 3e-4 of some tensors'
    scale on either side."""
    jcfg, tcfg, jp, tp = diamnet_pair(mem_init)
    rng = np.random.default_rng(MEM_INITS.index(mem_init))
    g_len = np.array([2, 4, 5, 7, 12], np.float32)
    p_len = np.array([3, 5, 4, 5, 2], np.float32)
    g = rng.standard_normal((5, 12, H)).astype(np.float32)
    p = rng.standard_normal((5, 5, H)).astype(np.float32)
    g *= (np.arange(12)[None, :] < g_len[:, None])[..., None]
    p *= (np.arange(5)[None, :] < p_len[:, None])[..., None]
    want = jdn.apply_diamnet(jp, jcfg, jnp.asarray(p), jnp.asarray(p_len),
                             jnp.asarray(g), jnp.asarray(g_len))
    with torch.no_grad():
        close(tdn.apply_diamnet(tp, tcfg, T(p), T(p_len), T(g), T(g_len)),
              want)

    g64, p64 = g.astype(np.float64), p.astype(np.float64)
    with jax.enable_x64():
        jp64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), jp)

        def jf(params, gg, pp):
            return (jdn.apply_diamnet(params, jcfg, pp, jnp.asarray(p_len),
                                      gg, jnp.asarray(g_len)) ** 2).sum()

        jgrads, jgg, jgp = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(
            jp64, jnp.asarray(g64), jnp.asarray(p64))
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
        jgg, jgp = np.asarray(jgg), np.asarray(jgp)
    assert jgg.dtype == np.float64
    tp = tp.double()
    tg, tpp = T(g64).requires_grad_(), T(p64).requires_grad_()
    out = tdn.apply_diamnet(tp, tcfg, tpp, T(p_len), tg, T(g_len))
    (out ** 2).sum().backward()
    assert_tree_grads_match(tp, jgrads, 10, zero_suffix="ln_k/1", tol=1e-9)
    for a, d in ((tg.grad, jgg), (tpp.grad, jgp)):
        assert np.abs(a.numpy() - d).max() <= 1e-9 * np.abs(d).max()


@pytest.mark.parametrize("agg_mode", ["aggregate_first", "kernel"])
def test_diamnet_pipeline_loss_and_gradients_match(agg_mode):
    """diamnet_forward over a whole-graph batch and the query batch (the
    port batches every (query, graph) pair where desco_tpu maps the
    queries) and diamnet_train_loss's gradients; the graph tower in both
    of the port's aggregation modes (the plain versions of K2 / K3 on the
    CPU)."""
    tb, jb, qb = whole_graph_batches(4)
    jt = jbd.diamnet_tower_config(H, 2)
    gcfg = tbd.diamnet_tower_config(H, 2, agg_mode=agg_mode)
    pcfg = tbd.diamnet_tower_config(H, 2)
    dn_kw = dict(hidden_dim=H, pattern_dim=H, graph_dim=H)
    jdc, tdc = jdn.DIAMNetConfig(**dn_kw), tdn.DIAMNetConfig(**dn_kw)
    jp = jbd.init_diamnet_pipeline(jax.random.PRNGKey(6), jt, jdc)
    k1, k2 = jax.random.split(jax.random.PRNGKey(60))
    jp["diamnet"]["pred2"] = (
        jax.random.normal(k1, jp["diamnet"]["pred2"][0].shape) * 0.3,
        jax.random.normal(k2, (1,)) * 0.3)
    tp = params_from_jax(_flatten(jp))
    pos, qpos = tbd.node_positions(tb), tbd.node_positions(qb)
    seq_len = int(np.bincount(tb.node_graph[tb.node_mask > 0]).max())
    jargs = (jax_batch(tb), jnp.asarray(pos), seq_len, jax_batch(qb),
             jnp.asarray(qpos), 4)
    want = jax.jit(jbd.diamnet_forward, static_argnums=(1, 2, 5, 8))(
        jp, jt, jdc, *jargs)
    wl, jgrads = jax.jit(jax.value_and_grad(jbd.diamnet_train_loss),
                         static_argnums=(1, 2, 5, 8))(jp, jt, jdc, *jargs)
    targs = (tb.to("cpu", training=True), T(pos), seq_len, qb.to("cpu"),
             T(qpos), 4)
    with torch.no_grad():
        got = tbd.diamnet_forward(tp, gcfg, pcfg, tdc, *targs)
    assert tuple(got.shape) == (tb.g_cap, 4)
    close(got, want)
    loss = tbd.diamnet_train_loss(tp, gcfg, pcfg, tdc, *targs)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(wl), rtol=1e-5)
    assert_tree_grads_match(tp, jgrads, 20, zero_suffix="ln_k/1")
