"""Gradients of desco_tpu_torch against desco_tpu: the backward kernels'
plain versions (K3 behind the fused typed aggregation, K4 behind the
sorted segment-sum), the training losses and the optimizer.

Same inputs (numpy, seeded) and the same weights (desco_tpu's init carried
over with ``params_from_jax``), dropout 0, float32 on both sides. desco_tpu
runs its XLA float32 path (``agg_mode='aggregate_first'``) unless a test
says otherwise; where it reaches a Pallas kernel the kernel runs in
interpret mode, as tests/test_pallas_segment.py runs it. Tolerances:
values rtol 1e-5, gradients rtol 1e-4 with atol 1e-6 of the tensor's
scale (only the summation order differs); against the Pallas path, which
reduces bf16 cotangents, error / tensor scale < 2e-2, that test's own
bound."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import desco_tpu.ops.pallas_segment as ps
from desco_tpu.models import gossip as jgossip
from desco_tpu.models import neighborhood as jneigh
from desco_tpu.pipeline import PipelineConfig as JConfig
from desco_tpu.pipeline import model_configs as j_model_configs
from desco_tpu.train import loop as jloop
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
from desco_tpu_torch.data.synthetic import random_connected_graphs
from desco_tpu_torch.data.workload import Workload
from desco_tpu_torch.graph.atlas import gen_queries
from desco_tpu_torch.models import gossip as tgossip
from desco_tpu_torch.models import neighborhood as tneigh
from desco_tpu_torch.ops import cuda_segment as cs
from desco_tpu_torch.pipeline import PipelineConfig, build_query_batch
from desco_tpu_torch.pipeline import model_configs as t_model_configs
from desco_tpu_torch.train import loop as tloop
from desco_tpu_torch.train.checkpoint import flatten_params, params_from_jax
from desco_tpu_torch.truth import native as truth_native

from test_torch_shmp import jax_batch, one_torch_thread  # noqa: F401

T = torch.from_numpy
CFG = dict(query_sizes=(3, 4), depth=2, neigh_layer_num=2,
           neigh_hidden_dim=16, agg_mode="aggregate_first")


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run desco_tpu's Pallas kernels in interpret mode on the CPU."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(kernel, **kw):
        kw["interpret"] = True
        return orig(kernel, **kw)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)


def typed_case(rng, n=128, t=2, h=64, e=256, pad=64):
    """A (dst,type)-sorted edge stream with pad edges on the zero pad node
    n-1 (as pack_samples lays them out), and its backward permutation."""
    x = rng.standard_normal((n, h)).astype(np.float32)
    x[n - 1] = 0.0
    dst = rng.integers(0, n - 1, e)
    typ = rng.integers(0, t, e)
    src = rng.integers(0, n - 1, e)
    keys = dst * t + typ
    order = np.argsort(keys, kind="stable")
    keys = np.concatenate([keys[order], np.full(pad, (n - 1) * t + 63)])
    src = np.concatenate([src[order], np.full(pad, n - 1)])
    w = (rng.standard_normal((t, h, h)) * 0.1).astype(np.float32)
    # pad edges sort last because src = pad node is the largest id
    perm = np.lexsort((keys % t, src)).astype(np.int32)
    return x, src.astype(np.int32), keys.astype(np.int32), w, perm


def torch_fused_grads(x, src, keys, w, t, n, perm):
    xs, ws = T(x).clone().requires_grad_(), T(w).clone().requires_grad_()
    out = cs.fused_typed_transform_aggregate(
        xs, T(src), T(keys), ws, t, n,
        bwd_perm=None if perm is None else T(perm))
    (out ** 2).mean().backward()
    return xs.grad.numpy(), ws.grad.numpy()


@pytest.mark.parametrize("with_perm", [True, False],
                         ids=["bwd_perm", "legacy"])
def test_k3_plain_matches_pallas_interpret_grads(rng, interpret_mode,
                                                 with_perm):
    """K3's plain version (and the legacy backward without a permutation)
    against desco_tpu's ``_fused_perm`` / ``_fused_legacy`` VJPs through
    the interpreted Pallas kernel."""
    n, t = 128, 2
    x, src, keys, w, perm = typed_case(rng, n, t)
    perm = perm if with_perm else None

    def f(x_, w_):
        return (ps.fused_typed_transform_aggregate(
            x_, jnp.asarray(src), jnp.asarray(keys), w_, t, n,
            bwd_perm=None if perm is None else jnp.asarray(perm)) ** 2
        ).mean()

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    got = torch_fused_grads(x, src, keys, w, t, n, perm)
    for a, d in zip(got, want):
        d = np.asarray(d)
        rel = np.abs(a - d).max() / (np.abs(d).max() + 1e-9)
        assert rel < 2e-2, rel


@pytest.mark.parametrize("with_perm", [True, False],
                         ids=["bwd_perm", "legacy"])
@pytest.mark.parametrize("t,h", [(2, 64), (6, 16)])
def test_k3_plain_matches_xla_autodiff(rng, with_perm, t, h):
    """The same gradients against JAX autodiff of the XLA float32 path."""
    from desco_tpu.ops.segment import segment_sum

    n = 128
    x, src, keys, w, perm = typed_case(rng, n, t, h, e=400)

    def ref_f(x_, w_):
        msgs = jnp.take(x_, jnp.asarray(src), axis=0, fill_value=0.0)
        d = jnp.asarray((keys // t).astype(np.int32))
        ty = jnp.asarray((keys % t).astype(np.int32))
        wt = jnp.take(w_, jnp.minimum(ty, t - 1), axis=0)
        tm = jnp.einsum("eh,ehk->ek", msgs, wt)
        live = (jnp.asarray(keys) < n * t)[:, None]
        return (segment_sum(tm * live, d, n) ** 2).mean()

    want = jax.grad(ref_f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    got = torch_fused_grads(x, src, keys, w, t, n,
                            perm if with_perm else None)
    for a, d in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(d), rtol=1e-4, atol=1e-5)


def test_pack_samples_bwd_perm_is_the_src_type_lexsort():
    """``edge_bwd_perm`` sorts the packed edge slots by (src, type) with
    the pad edges last, which K3's CSR walk relies on; a wrong
    permutation is refused."""
    graphs = random_connected_graphs(3, np.random.default_rng(5))
    samples, _ = Workload(graphs).neighborhood_samples(depth=2)
    (b,) = pack_samples(samples, *auto_capacities(samples, g_cap=256))
    np.testing.assert_array_equal(
        b.edge_bwd_perm, np.lexsort((b.edge_type, b.edge_src)))
    n_live = int((b.edge_type != 63).sum())
    assert 0 < n_live < b.e_cap  # there are pad slots to sort last
    assert (b.edge_type[b.edge_bwd_perm[n_live:]] == 63).all()
    t = 6
    keys = T((b.edge_dst * t + b.edge_type).astype(np.int32))
    src = T(b.edge_src.astype(np.int32))
    st = cs.typed_streams(src, keys, t, b.n_cap, b.n_cap,
                          T(b.edge_bwd_perm.astype(np.int32)))
    skey = st.bwd_skey.numpy()
    assert (np.diff(skey) >= 0).all()
    assert (skey[n_live:] == cs.PAD_SKEY).all() and skey[n_live - 1] < \
        b.n_cap * t
    assert int(st.bwd_offs[-1]) == n_live
    with pytest.raises(ValueError, match="order"):
        cs.typed_streams(src, keys, t, b.n_cap, b.n_cap,
                         torch.arange(b.e_cap, dtype=torch.int32))


def test_k4_plain_matches_sorted_segment_sum_ad(rng, interpret_mode):
    """Value and gradient of the differentiable sorted segment-sum. The
    Pallas kernel reduces bf16 messages: the messages here are multiples
    of 1/4, exact in bf16, so the f32 comparison is fair."""
    n_seg, k = 300, 64
    seg = np.sort(rng.integers(0, n_seg, 600))
    seg = np.concatenate([[-1, -1], seg, np.full(38, 2 ** 30)]).astype(
        np.int32)
    msgs = (rng.integers(-8, 9, (len(seg), k)) / 4.0).astype(np.float32)
    wgt = rng.standard_normal((n_seg, k)).astype(np.float32)

    def f(m):
        return (ps.sorted_segment_sum_ad(m, jnp.asarray(seg), n_seg)
                * jnp.asarray(wgt)).sum()

    ref_out = np.asarray(ps.sorted_segment_sum_ad(
        jnp.asarray(msgs), jnp.asarray(seg), n_seg))
    ref_grad = np.asarray(jax.grad(f)(jnp.asarray(msgs)))
    m = T(msgs).clone().requires_grad_()
    out = cs.sorted_segment_sum(m, T(seg), n_seg)
    (out * T(wgt)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(m.grad.numpy(), ref_grad, rtol=1e-5)
    assert (m.grad.numpy()[:2] == 0).all() and (
        m.grad.numpy()[-38:] == 0).all()
    np.testing.assert_array_equal(
        cs.segment_sum_vjp(T(wgt), T(seg), n_seg).numpy(), ref_grad)


# ------------------------------------------------------------------ losses
def test_smooth_l1_matches(rng):
    a = (rng.standard_normal((40, 7)) * 2).astype(np.float32)
    b = (rng.standard_normal((40, 7)) * 2).astype(np.float32)
    np.testing.assert_allclose(
        tneigh.smooth_l1(T(a), T(b)).numpy(),
        np.asarray(jneigh.smooth_l1(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-7)


def labeled_stage(seed=0, n_graphs=4):
    """(target batch with exact labels, gossip batch with labels, query
    batch) at a tiny size: real truth from VF2, stage-1 counts made up."""
    cfg = PipelineConfig(**CFG)
    rng = np.random.default_rng(seed)
    graphs = random_connected_graphs(n_graphs, rng)
    graphs = [g for g in graphs if g.n_nodes <= 40] or graphs[:1]
    wl = Workload(graphs)
    truth = np.concatenate(truth_native.parallel_canonical_counts(
        graphs, gen_queries(cfg.query_ids), 2))
    samples, nindex = wl.neighborhood_samples(cfg.depth, truth=truth)
    for s in samples:
        s.x = rng.standard_normal((s.n_nodes, 1)).astype(np.float32)
    (tb,) = pack_samples(samples, *auto_capacities(samples, g_cap=4096),
                         n_queries=truth.shape[1])
    counts = truth[nindex.indicator] * rng.uniform(0.5, 1.5, (len(samples), 1))
    gs = wl.gossip_samples(counts, nindex, truth)
    (gb,) = pack_samples(gs, *auto_capacities(gs, g_cap=64),
                         n_queries=truth.shape[1])
    return cfg, tb, gb, build_query_batch(cfg)


@pytest.fixture(scope="module")
def stage():
    return labeled_stage()


def neigh_pair(seed=3):
    jt, jq = j_model_configs(JConfig(**CFG))
    jparams = jneigh.init_neighborhood_model(jax.random.PRNGKey(seed), jt, jq)
    return (jt, jq, jparams), params_from_jax(_flatten(jparams))


def assert_grads_match(tparams, jgrads, min_nonzero=1):
    got = {k: v for k, v in flatten_grads(tparams).items()}
    want = _flatten(jgrads)
    assert set(got) == set(want)
    nonzero = 0
    for key, d in want.items():
        scale = float(np.abs(d).max())
        nonzero += scale > 0
        np.testing.assert_allclose(got[key], d, rtol=1e-4,
                                   atol=1e-6 * max(scale, 1e-30),
                                   err_msg=key)
    assert nonzero >= min_nonzero


def flatten_grads(tparams):
    from desco_tpu_torch.train.checkpoint import jax_key

    return {jax_key(n): (p.grad if p.grad is not None
                         else torch.zeros_like(p)).numpy()
            for n, p in tparams.named_parameters()}


@pytest.mark.parametrize("agg_mode", ["aggregate_first", "kernel"])
def test_train_and_test_loss_match(stage, agg_mode):
    """Values and every parameter's gradient of the neighborhood losses.
    ``kernel`` runs the port's K2/K3 plain versions (forward fused,
    backward through the batch's ``edge_bwd_perm``) against the same
    desco_tpu reference."""
    cfg, tb, _, qb = stage
    (jt, jq, jparams), tparams = neigh_pair()
    tt, tq = t_model_configs(
        dataclasses.replace(cfg, agg_mode=agg_mode), "cpu")
    jb, jqb = jax_batch(tb), jax_batch(qb)
    want, jgrads = jax.value_and_grad(jneigh.train_loss)(
        jparams, jt, jq, jb, jqb)
    want_test = float(jneigh.test_loss(jparams, jt, jq, jb, jqb))
    b, q = tb.to("cpu", training=True), qb.to("cpu")
    loss = tneigh.train_loss(tparams, tt, tq, b, q)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(
            float(tneigh.test_loss(tparams, tt, tq, b, q)), want_test,
            rtol=1e-5)
    assert_grads_match(tparams, jgrads, min_nonzero=10)


def gossip_pair(seed=2, hidden=16, emb=16):
    jp = jgossip.init_gossip_model(jax.random.PRNGKey(seed), input_dim=1,
                                   hidden_dim=hidden, emb_channels=emb,
                                   layer_num=2)
    return jp, params_from_jax(_flatten(jp))


def test_gossip_loss_matches(stage, rng):
    """Value and gradients of the gossip loss (a SUM over nodes and
    queries); ``pre`` sits behind the detach and gets a zero gradient in
    both packages. Also the gate table."""
    _, _, gb, _ = stage
    jp, tp = gossip_pair()
    q_embs = rng.standard_normal((gb.node_y.shape[1], 16)).astype(np.float32)
    want, jgrads = jax.value_and_grad(jgossip.gossip_loss)(
        jp, jax_batch(gb), jnp.asarray(q_embs))
    loss = tgossip.gossip_loss(tp, gb.to("cpu", training=True), T(q_embs))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert_grads_match(tp, jgrads, min_nonzero=10)
    assert float(np.abs(_flatten(jgrads)["pre/0"]).max()) == 0.0
    with torch.no_grad():
        np.testing.assert_allclose(
            tgossip.gate_values(tp, T(q_embs)).numpy(),
            np.asarray(jgossip.gate_values(jp, jnp.asarray(q_embs))),
            rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_make_adam_matches_optax_chain(rng, weight_decay):
    """The same numpy gradient sequence through desco_tpu's optax chain
    and the port's Adam, the learning rate changing on the way."""
    _, tparams = neigh_pair(seed=1)
    flat = flatten_params(tparams)
    jparams = {k: jnp.asarray(v) for k, v in flat.items()}
    tx = jloop.make_adam(weight_decay)
    jstate = tx.init(jparams)
    opt = tloop.make_adam(tparams, weight_decay)
    from desco_tpu_torch.train.checkpoint import jax_key

    named = {jax_key(n): p for n, p in tparams.named_parameters()}
    for step in range(6):
        lr = 1e-2 if step < 3 else 5e-3
        grads = {k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(
            -4, 1)).astype(np.float32) for k, v in flat.items()}
        upd, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(
            jparams, jax.tree_util.tree_map(lambda u: u * lr, upd))
        opt.zero_grad()
        for k, p in named.items():
            p.grad.copy_(T(grads[k]))
        opt.step(lr)
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_rejected_step_leaves_state_untouched(rng):
    _, tparams = neigh_pair(seed=1)
    opt = tloop.make_adam(tparams, 1e-2)
    opt.grad.copy_(T(rng.standard_normal(opt.grad.shape).astype(np.float32)))
    opt.step(1e-2, torch.tensor(True))
    before = (opt.flat.clone(), opt.mu.clone(), opt.nu.clone(),
              float(opt.count))
    opt.grad.fill_(float("nan"))
    opt.step(1e-2, torch.tensor(False))
    assert torch.equal(opt.flat, before[0])
    assert torch.equal(opt.mu, before[1]) and torch.equal(opt.nu, before[2])
    assert float(opt.count) == before[3] == 1.0


def test_gradient_free_parameters_still_decay(stage, rng):
    """optax updates every leaf: with weight decay the gossip ``pre``
    layer (no gradient, behind the detach) decays. torch.optim.Adam would
    skip a parameter whose .grad is None; the port's Adam gives it a zero
    gradient and agrees with desco_tpu."""
    _, _, gb, _ = stage
    jp, tp = gossip_pair()
    q_embs = rng.standard_normal((gb.node_y.shape[1], 16)).astype(np.float32)
    tx = jloop.make_adam(1e-2)
    step = jloop.gossip_step_fn(0.0, jnp.asarray(q_embs), tx)
    jp2, _, jloss = step(jp, tx.init(jp), jax_batch(gb), 1e-3,
                         jax.random.PRNGKey(0))
    before = tp["pre"].w.detach().clone()
    opt = tloop.make_adam(tp, 1e-2)
    loss, ok = tloop.train_step(
        tp, opt, tloop.gossip_loss_fn(0.0, T(q_embs)),
        gb.to("cpu", training=True), 1e-3, None)
    assert bool(ok)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float((tp["pre"].w.detach() - before).abs().max()) > 1e-4
    for key, want in _flatten(jp2).items():
        if key.startswith("pre/"):
            np.testing.assert_allclose(flatten_params(tp)[key],
                                       np.asarray(want), rtol=1e-5,
                                       atol=1e-7)


# ------------------------------------------------------------ trajectories
def test_neighborhood_five_step_trajectory(stage):
    """Five Adam steps on one batch: the loss trajectory follows
    desco_tpu's (rtol 1e-3: Adam turns a 1e-7 difference of a near-zero
    gradient into a full lr step, so parameters drift apart slowly)."""
    cfg, tb, _, qb = stage
    (jt, jq, jparams), tparams = neigh_pair()
    tt, tq = t_model_configs(cfg, "cpu")
    tx = jloop.make_adam(0.0)
    jstep = jax.jit(jloop.neighborhood_step_fn(jt, jq, jax_batch(qb), tx))
    jstate, jb = tx.init(jparams), jax_batch(tb)
    opt = tloop.make_adam(tparams)
    loss_fn = tloop.neighborhood_loss_fn(tt, tq, qb.to("cpu"))
    b = tb.to("cpu", training=True)
    want, got = [], []
    for i in range(5):
        jparams, jstate, jl = jstep(jparams, jstate, jb, 1e-3,
                                    jax.random.PRNGKey(i))
        want.append(float(jl))
        got.append(float(tloop.train_step(tparams, opt, loss_fn, b, 1e-3,
                                          None)[0]))
    assert want[-1] < want[0]
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_gossip_five_step_trajectory(stage, rng):
    _, _, gb, _ = stage
    jp, tp = gossip_pair()
    q_embs = rng.standard_normal((gb.node_y.shape[1], 16)).astype(np.float32)
    tx = jloop.make_adam(0.0)
    jstep = jax.jit(jloop.gossip_step_fn(0.0, jnp.asarray(q_embs), tx))
    jstate, jb = tx.init(jp), jax_batch(gb)
    opt = tloop.make_adam(tp)
    loss_fn = tloop.gossip_loss_fn(0.0, T(q_embs))
    b = gb.to("cpu", training=True)
    want, got = [], []
    for i in range(5):
        jp, jstate, jl = jstep(jp, jstate, jb, 1e-3, jax.random.PRNGKey(i))
        want.append(float(jl))
        got.append(float(tloop.train_step(tp, opt, loss_fn, b, 1e-3,
                                          None)[0]))
    assert want[-1] < want[0]
    np.testing.assert_allclose(got, want, rtol=1e-3)
