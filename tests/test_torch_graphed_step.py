"""The compiled training step (desco_tpu_torch/utils/cuda_graphs.py) on the
CPU, where it runs on its static buffers without a capture.

The static-buffer steps must equal the eager steps bit for bit (the same
operations on copies of the same batches): train and val losses, the
final parameters and Adam's mu / nu / count, f32 and bf16 target tower,
also across a plateau decay, a rejected step and a resume; the gossip
stage with and without dropout. The gossip loss draws each query's
dropout masks ahead of its checkpointed call: its steps equal, bit for
bit, the scheme that drew them inside the forward and rewound the
generator for the recomputation (kept here as a plain reference). Against
desco_tpu's ``run_training`` (its jitted ``carried_step`` and
``eval_jit``) the static steps hold the losses to the loop tolerance of
tests/test_torch_dp.py, rtol 1e-5 (same inputs and weights, dropout 0;
only the summation order differs), and the parameters to rtol 1e-4 with
atol 1e-5 of each tensor's scale: Adam divides each gradient by its own
root mean square, so where a gradient is near zero its 1e-7 relative
difference reaches the parameter in full, and over 14 steps one element
of the query tower's last post linear lies 2.8e-6 of its tensor's scale
from desco_tpu's, for the eager loop as for the static one (the DP test's
1e-6 holds at D = 2 on these batches). A static step makes no read-back and no
host-to-device copy, which a capture on the card could not hold; the
launch counters add a capture's launches per replay."""

import copy
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from desco_tpu.train import loop as jloop
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch.models import gossip as tgossip
from desco_tpu_torch.models import neighborhood as tneigh
from desco_tpu_torch.models.shmp_gnn import batch_typed_streams, prepare_batch
from desco_tpu_torch.ops.segment import typed_edge_aggregate
from desco_tpu_torch.ops import cuda_segment as cs
from desco_tpu_torch.pipeline import (build_query_batch,
                                      train_neighborhood_stage)
from desco_tpu_torch.pipeline import model_configs as t_model_configs
from desco_tpu_torch.utils import cuda_graphs as graphed
from desco_tpu_torch.train import loop as tloop
from desco_tpu_torch.train.checkpoint import flatten_params

from test_torch_dp import dp_data, j_host  # noqa: F401
from test_torch_grad import gossip_pair, neigh_pair
from test_torch_shmp import jax_batch, one_torch_thread  # noqa: F401
from test_torch_train import (QUIET, neigh_setup,  # noqa: F401
                              tiny_cfg, tiny_data)


def assert_runs_equal(a, b, paths):
    """Two runs' TrainResults and their ``.last`` snapshots (parameters
    and Adam's state), bit for bit."""
    assert a.train_losses == b.train_losses
    np.testing.assert_array_equal(a.val_losses, b.val_losses)
    assert a.best_val == b.best_val
    for x, y in ((a.params, b.params), (a.best_params, b.best_params)):
        fx, fy = flatten_params(x), flatten_params(y)
        for key, arr in fx.items():
            np.testing.assert_array_equal(arr, fy[key], err_msg=key)
    opts = [np.load(p + ".last.opt.npz") for p in paths]
    assert sorted(opts[0].files) == sorted(opts[1].files)
    assert any(k.startswith("mu/") for k in opts[0].files)
    for key in opts[0].files:
        np.testing.assert_array_equal(opts[0][key], opts[1][key],
                                      err_msg=key)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_static_step_equals_eager_bit_for_bit(tiny_cfg, tiny_data, tmp_path,
                                              bf16):
    """2 epochs of the neighborhood stage: the static steps (train and
    eval) against the eager ones, the same weights and seed."""
    train, val, _ = tiny_data
    cfg = dataclasses.replace(tiny_cfg, neigh_epochs=2, train_bf16=bf16)
    qb = build_query_batch(cfg)
    runs, paths = [], []
    for g in (False, True):
        paths.append(str(tmp_path / f"run{int(g)}"))
        res, _, _ = train_neighborhood_stage(cfg, train, val, qb,
                                             ckpt_path=paths[-1],
                                             graphed=g, **QUIET)
        runs.append(res)
    assert runs[0].train_losses[1] != runs[0].train_losses[0]
    assert_runs_equal(*runs, paths)


def test_plateau_decay_moves_the_device_lr(tiny_cfg, tiny_data, tmp_path):
    """Patience 0 and a learning rate too small to improve the val loss:
    the plateau schedule halves the device learning rate after every
    epoch past the first, and static still equals eager."""
    train, val, _ = tiny_data
    tt, tq, _, qb = neigh_setup(tiny_cfg)
    runs, paths, logs = [], [], []
    for g in (False, True):
        lines = []
        paths.append(str(tmp_path / f"pl{int(g)}"))
        params = tneigh.init_neighborhood_model(
            tt, tq, torch.Generator().manual_seed(0))
        runs.append(tloop.train_neighborhood(
            params, tt, tq, qb, train.batches, val.batches, epochs=4,
            lr=1e-8, min_lr=1e-12, patience=0, ckpt_path=paths[-1],
            snapshot_every=1, log_every=1, device="cpu", graphed=g,
            log_fn=lines.append))
        logs.append([ln.split(" lr ")[1].split()[0] for ln in lines])
    assert logs[0] == logs[1] == ["1.00e-08", "5.00e-09", "2.50e-09",
                                  "1.25e-09"]
    assert_runs_equal(*runs, paths)


@pytest.mark.parametrize("stage", ["neighborhood", "gossip"])
def test_static_steps_match_desco_tpu_run_training(dp_data, stage):
    """``run_training`` on one device with the static steps against
    desco_tpu's jitted ``carried_step`` / ``eval_jit`` loop: 2 epochs,
    the same weights, seed and batches (both steps static in both
    stages), dropout 0."""
    cfg, tbs, gbs, qb = dp_data
    kw = dict(epochs=2, lr=1e-3, seed=4, log_fn=lambda *_: None)
    if stage == "neighborhood":
        batches = list(tbs)
        (jt, jq, jparams), tparams = neigh_pair()
        want = jloop.train_neighborhood(
            jparams, jt, jq, jax_batch(qb), [j_host(b) for b in batches],
            [j_host(b) for b in batches[:2]], **kw)
        tt, tq = t_model_configs(cfg, "cpu")
        got = tloop.train_neighborhood(
            tparams, tt, tq, qb, batches, batches[:2], device="cpu",
            graphed=True, **kw)
    else:
        batches = list(gbs[:5])
        q_embs = np.random.default_rng(7).standard_normal(
            (gbs[0].node_y.shape[1], 16)).astype(np.float32)
        jp, tp = gossip_pair()
        want = jloop.train_gossip(
            jp, jnp.asarray(q_embs), [j_host(b) for b in batches],
            [j_host(b) for b in batches[:2]], dropout=0.0, **kw)
        got = tloop.train_gossip(
            tp, torch.from_numpy(q_embs), batches, batches[:2], dropout=0.0,
            device="cpu", graphed=True, **kw)
    np.testing.assert_allclose(got.train_losses, want.train_losses, rtol=1e-5)
    np.testing.assert_allclose(got.val_losses, want.val_losses, rtol=1e-5)
    final = flatten_params(got.params)
    for key, w in _flatten(want.params).items():
        w = np.asarray(w)
        np.testing.assert_allclose(final[key], w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=key)


def test_static_step_makes_no_read_back(tiny_cfg, tiny_data, monkeypatch):
    """After one step that sets up what a run keeps (the towers' bias ids),
    a static train step and a static eval step run with every read-back
    (``item``, ``__bool__``, ``tolist``, ``numpy``, ``cpu``, ``float``,
    ``int``) and every host-to-device tensor (``torch.tensor``,
    ``as_tensor``, ``new_tensor``) raising, and still update the
    parameters and the carries."""
    train, val, _ = tiny_data
    tt, tq, params, qb = neigh_setup(tiny_cfg)
    qb = qb.to("cpu")
    dev = [b.to("cpu", training=True) for b in train.batches[:2]]
    opt = tloop.make_adam(params)
    lr = torch.tensor(1e-3)
    steps = tloop.Steps(
        params, opt, tloop.neighborhood_loss_fn(tt, tq, qb),
        tloop.neighborhood_eval_fn(tt, tq, qb), dev, dev, lr, None, "cpu",
        graphed=True,
        prepare=lambda b, backward: prepare_batch(
            b, tt.n_edge_types, backward))
    prepare_batch(qb, tq.n_edge_types, backward=True)
    assert isinstance(steps.train, graphed.GraphedStep)
    assert isinstance(steps.eval, graphed.GraphedStep)
    steps.train(dev[0])
    before = opt.flat.clone()

    def refuse(*_a, **_k):
        raise AssertionError("a read-back or host copy in a static step")

    for name in ("item", "__bool__", "tolist", "numpy", "cpu", "__float__",
                 "__int__", "new_tensor"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    steps.train(dev[1])
    steps.eval(dev[1])
    monkeypatch.undo()
    assert not torch.equal(opt.flat, before)
    assert float(steps.train_carry[0]) > 0
    assert int(steps.train_carry[1]) == 0
    assert float(steps.eval_carry[1]) == float(dev[1].graph_mask.sum())


def test_static_batch_refuses_another_shape(tiny_data):
    """The static buffers take batches of their shape only, and only
    batches whose per-batch state was derived before the loop."""
    b0, b1 = (b.to("cpu", training=True)
              for b in tiny_data[0].batches[:2])
    prepare_batch(b0, 6, backward=True)
    static = graphed.static_like(b0)
    assert static.x is not b0.x and torch.equal(static.x, b0.x)
    assert static._typed_streams.bwd_rows is not None
    with pytest.raises(ValueError, match="_typed_streams"):
        graphed.copy_into(static, b1)
    prepare_batch(b1, 6, backward=True)
    graphed.copy_into(static, b1)
    assert torch.equal(static._typed_streams.keys, b1._typed_streams.keys)
    assert torch.equal(static._pool_offsets, b1._pool_offsets)
    wide = dataclasses.replace(b1, x=torch.zeros(b1.n_cap + 1, 1))
    with pytest.raises(ValueError, match="one shape"):
        graphed.copy_into(static, wide)


def test_no_collection_frees_no_cycle_inside():
    """A capture runs with the cyclic collector paused: an object held in
    a reference cycle (as a DP step holds its graphs) dies before or
    after it, never inside, and the collector runs again after it."""
    import gc
    import weakref

    class Held:
        pass

    def cycle():
        a = Held()
        a.self = a
        return weakref.ref(a)

    with graphed.no_collection():
        dead = cycle()
        kept = [Held() for _ in range(100_000)]  # enough to trigger one
        assert len(kept) == 100_000 and dead() is not None and not gc.isenabled()
    assert gc.isenabled()
    gc.collect()
    assert dead() is None


def test_launch_record_adds_the_capture_per_replay():
    """A stub capture that counts as the wrappers count while a graph
    records (no kernel launches on the CPU): the counters are put back
    after the capture, and N replays add N times its counts."""
    cs.reset_launches()
    cs.sorted_segment_sum.launches = 5  # launches before the capture
    rec = cs.LaunchRecord()
    with rec.capture():
        cs.fused_typed_transform_aggregate.launches += 8
        cs.fused_typed_transform_aggregate.launches_bf16 += 8
        cs.typed_aggregate_bwd.launches += 8
        cs.sorted_segment_sum.launches += 2
        cs.gather_segment_sum.launches += 8
        cs.gather_segment_sum_bwd.launches += 8
    captured = dict(rec.counts)
    assert captured["fused_typed_transform_aggregate_bf16"] == 8
    assert captured["sorted_segment_sum"] == 2
    assert captured["segment_sum_vjp"] == 0
    assert cs.read_launches() == {**{k: 0 for k in captured},
                                  "sorted_segment_sum": 5}
    for _ in range(7):
        rec.replayed()
    got = cs.read_launches()
    for key, n in captured.items():
        assert got[key] == 7 * n + (5 if key == "sorted_segment_sum" else 0)
    cs.reset_launches()


# ------------------------------------------------------------ gossip stage
def rewinding_gossip_loss(params, batch, query_embs, rate, generator):
    """The gossip training loss as the port computed it before the masks
    were drawn ahead: each query draws its masks inside the forward, the
    generator's state is snapshot before the query and restored when the
    checkpoint recomputes it."""
    deg = tgossip.direction_degrees(batch)
    nmask = batch.node_mask[:, None]

    def drop(x):
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=x.dtype) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def one_query(state, q_emb, x_col, y_col):
        generator.set_state(state)
        x = params["pre"](x_col[:, None])
        qe = q_emb[None, :].expand(x.shape[0], q_emb.shape[0])
        x = torch.cat([qe, x], dim=-1).detach() * nmask
        embs = [x]
        for conv in params["convs"]:
            g = tgossip._gate(conv, q_emb)
            agg = typed_edge_aggregate(
                x, batch.edge_src, batch.edge_dst, batch.edge_type, 2,
                streams=batch_typed_streams(batch, 2))
            mixed = g * agg[:, 0] + (1.0 - g) * agg[:, 1]
            wdeg = (g * deg[:, 0] + (1.0 - g) * deg[:, 1])[:, None]
            aggr = mixed @ conv["com"].w + conv["com"].b * wdeg
            x = conv["upd"](torch.cat([aggr, x], dim=-1))
            x = drop(torch.relu(x)) * nmask
            embs.append(x)
        post = params["post"]
        h = F.leaky_relu(drop(post[0](torch.cat(embs, dim=-1))), 0.1)
        h = torch.relu(post[2](torch.relu(post[1](h))))
        res = post[3](h)[:, 0] * batch.node_mask
        loss = torch.log2((res + x_col - y_col).abs() + 1.0)
        return (loss * batch.node_mask).sum()

    total = batch.x.new_zeros(())
    for q, q_emb in enumerate(query_embs):
        total = total + checkpoint(
            one_query, generator.get_state(), q_emb, batch.x[:, q],
            batch.node_y[:, q], use_reentrant=False,
            preserve_rng_state=False)
    return total


def gossip_query_embs(gbs):
    return torch.from_numpy(np.random.default_rng(7).standard_normal(
        (gbs[0].node_y.shape[1], 16)).astype(np.float32))


def test_gossip_masks_drawn_ahead_equal_the_rewinding_scheme(dp_data):
    """Two gossip train steps at dropout 0.01 from the same weights and
    generator seed: ``train_step`` with the masks drawn ahead against the
    rewinding scheme (the generator put back after the backward): the
    losses, the gradients, the parameters and the generator's state after
    each step, bit for bit; the masks drop entries."""
    _, _, gbs, _ = dp_data
    q = gossip_query_embs(gbs)
    batches = [b.to("cpu", training=True) for b in gbs[:2]]
    _, p0 = gossip_pair()
    rate, lr = 0.01, 1e-3
    runs = []
    for ahead in (True, False):
        p = copy.deepcopy(p0)
        opt = tloop.make_adam(p)
        gen = torch.Generator().manual_seed(5)
        steps = []
        for b in batches:
            if ahead:
                loss, _ = tloop.train_step(
                    p, opt, tloop.gossip_loss_fn(rate, q), b, lr, gen)
            else:
                opt.zero_grad()
                loss = rewinding_gossip_loss(p, b, q, rate, gen)
                end = gen.get_state()
                loss.backward()
                gen.set_state(end)
                loss = loss.detach()
                opt.step(lr, torch.isfinite(loss))
            steps.append((loss, opt.grad.clone(), opt.flat.clone(),
                          gen.get_state()))
        runs.append(steps)
    for (la, ga, pa, sa), (lb, gb_, pb, sb) in zip(*runs):
        assert torch.equal(la, lb)
        assert torch.equal(ga, gb_) and float(ga.abs().max()) > 0
        assert torch.equal(pa, pb)
        assert torch.equal(sa, sb)
    with torch.no_grad():
        plain = tgossip.gossip_loss(p0, batches[0], q)
    assert not torch.equal(runs[0][0][0], plain)


@pytest.mark.parametrize("dropout", [0.0, 0.01])
def test_gossip_static_step_equals_eager_bit_for_bit(dp_data, tmp_path,
                                                     dropout):
    """2 epochs of the gossip stage: the static train and eval steps
    against the eager ones, the same weights and seed."""
    _, _, gbs, _ = dp_data
    q = gossip_query_embs(gbs)
    runs, paths = [], []
    for g in (False, True):
        paths.append(str(tmp_path / f"g{int(g)}"))
        _, tp = gossip_pair()
        runs.append(tloop.train_gossip(
            tp, q, list(gbs[:5]), list(gbs[:2]), epochs=2, lr=1e-3, seed=4,
            dropout=dropout, ckpt_path=paths[-1], device="cpu", graphed=g,
            log_fn=lambda *_: None))
    assert runs[0].train_losses[1] != runs[0].train_losses[0]
    assert_runs_equal(*runs, paths)


def test_gossip_static_step_makes_no_read_back(dp_data, monkeypatch):
    """The static gossip train step with dropout (the masks drawn ahead,
    the checkpoint's recomputation in the backward) and its eval step
    make no read-back and no host-to-device tensor (as
    ``test_static_step_makes_no_read_back`` patches them)."""
    _, _, gbs, _ = dp_data
    q = gossip_query_embs(gbs)
    _, params = gossip_pair()
    dev = [b.to("cpu", training=True) for b in gbs[:2]]
    opt = tloop.make_adam(params)
    gen = torch.Generator().manual_seed(3)
    steps = tloop.Steps(
        params, opt, tloop.gossip_loss_fn(0.01, q), tloop.gossip_eval_fn(q),
        dev, dev, torch.tensor(1e-3), gen, "cpu", graphed=True,
        prepare=tloop.gossip_prepare)
    assert isinstance(steps.train, graphed.GraphedStep)
    assert isinstance(steps.eval, graphed.GraphedStep)
    steps.train(dev[0])
    before, state = opt.flat.clone(), gen.get_state()

    def refuse(*_a, **_k):
        raise AssertionError("a read-back or host copy in a static step")

    for name in ("item", "__bool__", "tolist", "numpy", "cpu", "__float__",
                 "__int__", "new_tensor"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    steps.train(dev[1])
    steps.eval(dev[1])
    monkeypatch.undo()
    assert not torch.equal(opt.flat, before)
    assert not torch.equal(gen.get_state(), state)
    assert float(steps.train_carry[0]) > 0
    assert int(steps.train_carry[1]) == 0
    assert float(steps.eval_carry[1]) == float(dev[1].node_mask.sum())
