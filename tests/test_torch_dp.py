"""desco_tpu_torch's data parallelism (parallel/dp.py, the DP training
loop, DP serving, the CLI's ``--n_devices``) against desco_tpu's, on the
CPU.

desco_tpu runs its DP step under ``shard_map`` over D of the 8 fake host
devices tests/conftest.py sets up; the port runs D = 2 and D = 4
replicas in one process, all on the CPU. Same numpy inputs from a seed,
same weights (desco_tpu's init carried over with ``params_from_jax``),
dropout 0 where the two packages are compared.

Tolerances: padded batches array-equal; DP losses rtol 1e-5 and reduced
gradients rtol 1e-4 with atol 1e-6 of each tensor's scale
(tests/test_torch_grad.py; only the summation order differs). The gossip
gradients of a 'sum' group cancel across batches, so their atol is 1e-6
of the sum of the batches' own scales (each batch's gradient keeps its
own rounding through the sum); the port's
DP prediction bit-equal to its single-device prediction, and within the
serving tolerance (rtol 1e-3, atol 1e-2, tests/test_torch_serving.py) of
desco_tpu's DP prediction."""

import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from desco_tpu.config import build_parser as j_build_parser
from desco_tpu.models import gossip as jgossip
from desco_tpu.batch.packed import PackedGraphs as JPacked
from desco_tpu.parallel import dp as jdp
from desco_tpu.train import loop as jloop
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch.batch.packed import auto_capacities, pack_samples
from desco_tpu_torch.config import build_parser
from desco_tpu_torch.data.synthetic import random_connected_graphs
from desco_tpu_torch.data.workload import Workload
from desco_tpu_torch.graph.atlas import gen_queries
from desco_tpu_torch.models import gossip as tgossip
from desco_tpu_torch.models import neighborhood as tneigh
from desco_tpu_torch.parallel import dp
from desco_tpu_torch.pipeline import PipelineConfig
from desco_tpu_torch.pipeline import model_configs as t_model_configs
from desco_tpu_torch.serving import CountingService
from desco_tpu_torch.train import loop as tloop
from desco_tpu_torch.train.checkpoint import flatten_params
from desco_tpu_torch.truth import native as truth_native

from test_torch_grad import (CFG, assert_grads_match, flatten_grads,
                             gossip_pair, neigh_pair)
from test_torch_shmp import jax_batch, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
NEIGH, GOSSIP = "release/r4/neigh.best", "release/r4/gossip.best"


@pytest.fixture(scope="module")
def dp_data():
    """Target batches (7), gossip batches (6, one graph each) with exact
    labels, and the query batch, at a tiny size."""
    from desco_tpu_torch.pipeline import build_query_batch

    cfg = PipelineConfig(**CFG)
    rng = np.random.default_rng(11)
    graphs = [g for g in random_connected_graphs(12, rng)
              if g.n_nodes <= 40][:6]
    wl = Workload(graphs)
    truth = np.concatenate(truth_native.parallel_canonical_counts(
        graphs, gen_queries(cfg.query_ids), 2))
    samples, nindex = wl.neighborhood_samples(cfg.depth, truth=truth)
    g_cap = -(-len(samples) // 5)
    tbs = pack_samples(samples, *auto_capacities(samples, g_cap=g_cap),
                       n_queries=truth.shape[1], need_bwd_perm=True)
    counts = truth[nindex.indicator] * rng.uniform(0.5, 1.5,
                                                   (len(samples), 1))
    gs = wl.gossip_samples(counts, nindex, truth)
    gbs = pack_samples(gs, *auto_capacities(gs, g_cap=1),
                       n_queries=truth.shape[1], need_bwd_perm=True)
    return cfg, tbs, gbs, build_query_batch(cfg)


def j_host(b):
    """desco_tpu's batch with the same host arrays (its DP predict stacks
    numpy batches)."""
    return JPacked(**dict(b.fields()))


def j_stack(batches):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                  *[jax_batch(b) for b in batches])


def grad_capture():
    """An optax transformation whose state after ``update`` is the
    gradient it was given (desco_tpu's DP step returns the state), with
    zero updates."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(
        lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


def j_dp_step(loss_fn, jparams, batches, d, kind):
    """desco_tpu's ``dp_step_fn`` over ``d`` fake devices: (loss, reduced
    gradients)."""
    mesh, tx = jdp.make_mesh(d), grad_capture()
    step = jdp.dp_step_fn(loss_fn, tx, mesh, weight_kind=kind)
    with mesh:
        _, grads, loss = jax.jit(step)(jparams, tx.init(jparams),
                                       j_stack(batches), jnp.float32(1e-3),
                                       jax.random.PRNGKey(0))
    return float(loss), grads


def port_reduced(tparams, loss_fn, batches, d, kind):
    """The port's DP (loss, reduced gradient), the gradient written into
    ``tparams``' .grad views (train/loop.Adam) for ``assert_grads_match``."""
    mesh = dp.make_mesh(d, "cpu")
    group = dp.place_batches(batches, mesh, training=True)
    loss, flat = dp.dp_loss_and_grads(loss_fn, tparams, group, mesh, kind)
    tloop.make_adam(tparams).grad.copy_(flat)
    return float(loss)


# ------------------------------------------------------------------- mesh
def test_make_mesh_places_replicas():
    mesh = dp.make_mesh(4, "cpu")
    assert mesh.size == 4 and set(mesh.devices) == {CPU}
    assert dp.make_mesh(0, "cpu").size == 1
    if not torch.cuda.is_available():  # the default device is the GPU
        with pytest.raises(RuntimeError, match="CUDA"):
            dp.make_mesh(2)


@pytest.mark.parametrize("d", [2, 4])
def test_pad_batches_to_multiple_is_array_equal(dp_data, d):
    _, tbs, _, _ = dp_data
    got = dp.pad_batches_to_multiple(list(tbs), d)
    want = jdp.pad_batches_to_multiple([jax_batch(b) for b in tbs], d)
    assert len(got) == len(want) and len(got) % d == 0
    for g, w in zip(got, want):
        for name, arr in g.fields():
            np.testing.assert_array_equal(arr, np.asarray(getattr(w, name)),
                                          err_msg=name)
    pads = got[len(tbs):]
    assert all(p.graph_mask.sum() == 0 and p.node_mask.sum() == 0
               for p in pads)
    groups = dp.reshape_for_dp(got, d)
    assert [len(g) for g in groups] == [d] * (len(got) // d)
    assert dp.pad_batches_to_multiple(got, d) is got


def test_replica_params_copy_once_per_other_device():
    """Replicas on the master's device read the master itself; another
    device gets one copy, made once and refreshed from the master by every
    later ``sync`` (no gradient crosses devices through autograd)."""
    _, tp = gossip_pair()
    reps = dp.ReplicaParams()
    meta = torch.device("meta")
    a = reps.sync(tp, [CPU, meta, CPU, meta])
    assert a[0] is tp and a[2] is tp and a[1] is a[3]
    assert a[1] is not tp and next(a[1].parameters()).device == meta
    assert reps.sync(tp, [CPU, meta])[1] is a[1]


# ------------------------------------------------------------- DP steps
@pytest.mark.parametrize("d,first", [(2, 0), (4, 4)],
                         ids=["two_full", "four_with_pad"])
def test_graphs_dp_step_matches_desco_tpu(dp_data, d, first):
    """The neighborhood ('graphs') step: loss and reduced gradients
    against desco_tpu's ``dp_step_fn``; ``four_with_pad`` is the last
    three batches and an all-masked pad batch, which must weigh exactly
    0."""
    cfg, tbs, _, qb = dp_data
    batches = dp.pad_batches_to_multiple(list(tbs[first:first + d]), d)
    assert (sum(b.graph_mask.sum() == 0 for b in batches)
            == (1 if first else 0))
    (jt, jq, jparams), tparams = neigh_pair()
    want, jgrads = j_dp_step(
        jloop.neighborhood_loss_fn(jt, jq, jax_batch(qb)), jparams,
        batches, d, "graphs")
    tt, tq = t_model_configs(cfg, "cpu")
    got = port_reduced(tparams, tloop.neighborhood_loss_fn(tt, tq,
                                                           qb.to("cpu")),
                       batches, d, "graphs")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_grads_match(tparams, jgrads, min_nonzero=10)
    # the weighted mean of the single-device losses
    live = [b for b in batches if b.graph_mask.sum() > 0]
    ws = [float(b.graph_mask.sum()) for b in live]
    with torch.no_grad():
        singles = [float(tneigh.train_loss(tparams, tt, tq,
                                           b.to("cpu", training=True),
                                           qb.to("cpu"))) for b in live]
    np.testing.assert_allclose(got, np.dot(singles, ws) / sum(ws),
                               rtol=1e-5)


@pytest.mark.parametrize("d", [2, 4])
def test_sum_dp_step_loss_is_the_sum_of_batch_losses(dp_data, rng, d):
    """The gossip ('sum') step: the DP loss is the sum of the per-batch
    losses (tests/test_parallel.py:104-132) and equals desco_tpu's, with
    its reduced gradients."""
    _, _, gbs, _ = dp_data
    batches = list(gbs[:d])
    q_embs = rng.standard_normal((gbs[0].node_y.shape[1], 16)).astype(
        np.float32)
    jp, tp = gossip_pair()
    want, jgrads = j_dp_step(jloop.gossip_loss_fn(0.0, jnp.asarray(q_embs)),
                             jp, batches, d, "sum")
    got = port_reduced(tp, tloop.gossip_loss_fn(0.0, torch.from_numpy(
        q_embs)), batches, d, "sum")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    reduced = flatten_grads(tp)
    scales, parts = {}, []
    for b in batches:
        _, single = gossip_pair()
        loss = tgossip.gossip_loss(single, b.to("cpu", training=True),
                                   torch.from_numpy(q_embs))
        loss.backward()
        parts.append(float(loss.detach()))
        for key, gr in flatten_grads(single).items():
            scales[key] = scales.get(key, 0.0) + float(np.abs(gr).max())
    for key, want_g in _flatten(jgrads).items():
        np.testing.assert_allclose(
            reduced[key], want_g, rtol=1e-4,
            atol=1e-6 * max(scales[key], 1e-30), err_msg=key)
    assert sum(scales[k] > 0 for k in scales) >= 10
    np.testing.assert_allclose(got, sum(parts), rtol=1e-5)
    ref = sum(float(jgossip.gossip_loss(jp, jax_batch(b),
                                        jnp.asarray(q_embs)))
              for b in batches)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_all_masked_gossip_batch_weighs_nothing(dp_data, rng):
    """A pad batch's gossip loss is exactly 0 (no NaN from an empty
    mean), so a sum group with one equals the group without it."""
    _, _, gbs, _ = dp_data
    [pad] = dp.pad_batches_to_multiple([gbs[0]] * 3, 2)[3:]
    q = torch.from_numpy(rng.standard_normal((gbs[0].node_y.shape[1], 16))
                         .astype(np.float32))
    _, tp = gossip_pair()
    with torch.no_grad():
        loss = tgossip.gossip_loss(tp, pad.to("cpu", training=True), q)
    assert float(loss) == 0.0
    mesh = dp.make_mesh(2, "cpu")
    group = dp.place_batches([gbs[0], pad], mesh, training=True)
    got, flat = dp.dp_loss_and_grads(tloop.gossip_loss_fn(0.0, q), tp,
                                     group, mesh, "sum")
    one, flat1 = dp.dp_loss_and_grads(
        tloop.gossip_loss_fn(0.0, q), tp, group[:1], dp.make_mesh(1, "cpu"),
        "sum")
    assert float(got) == float(one)
    assert torch.equal(flat, flat1)


def test_dp_steps_repeat_and_rewind_their_generators(dp_data, rng):
    """Two same-seed DP gossip steps with dropout give the same bits; each
    replica's generator ends where a forward alone leaves it (the
    checkpointed recompute draws nothing: the masks are drawn ahead), and
    the step's loss is the sum of those forwards."""
    _, _, gbs, _ = dp_data
    mesh = dp.make_mesh(2, "cpu")
    group = dp.place_batches(list(gbs[:2]), mesh, training=True)
    q = torch.from_numpy(rng.standard_normal((gbs[0].node_y.shape[1], 16))
                         .astype(np.float32))
    _, tp0 = gossip_pair()
    runs = []
    for _ in range(2):
        tp = copy.deepcopy(tp0)
        opt = tloop.make_adam(tp)
        step = dp.DPStep(tloop.gossip_loss_fn(0.3, q), opt, mesh, "sum")
        gens = dp.replica_generators(mesh, 5)
        loss, ok = step(tp, group, 1e-3, gens)
        assert bool(ok)
        runs.append((float(loss), opt.grad.clone(), opt.flat.clone(), gens))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(runs[0][2], runs[1][2])
    fresh = dp.replica_generators(mesh, 5)
    with torch.no_grad():
        alone = [tgossip.gossip_loss(tp0, b, q, 0.3, True, g)
                 for b, g in zip(group, fresh)]
    for g_step, g_alone in zip(runs[0][3], fresh):
        assert torch.equal(g_step.get_state(), g_alone.get_state())
    np.testing.assert_allclose(runs[0][0], float(alone[0] + alone[1]),
                               rtol=1e-6)
    # the replicas draw different masks
    assert not torch.equal(dp.replica_generators(mesh, 5)[0].get_state(),
                           dp.replica_generators(mesh, 5)[1].get_state())


def test_reseeded_replica_generators_equal_fresh_ones():
    """Reseeding a run's replica generators in place gives the state of
    fresh ones from the same seed (a captured DP step keeps its
    generators and reseeds them every epoch)."""
    mesh = dp.make_mesh(3, "cpu")
    gens = dp.replica_generators(mesh, 1)
    for g in gens:
        torch.rand(5, generator=g)
    again = dp.reseed_replica_generators(gens, 9)
    assert again is gens
    for g, fresh in zip(gens, dp.replica_generators(mesh, 9)):
        assert torch.equal(g.get_state(), fresh.get_state())


@pytest.mark.parametrize("stage,dropout", [("neighborhood", 0.0),
                                           ("gossip", 0.0),
                                           ("gossip", 0.01)])
def test_dp_static_step_equals_eager_bit_for_bit(dp_data, tmp_path, stage,
                                                 dropout):
    """``run_training`` over a D = 2 mesh, 2 epochs: the static DP train
    step (the group of two batches in static buffers, both replicas'
    generators) and the static eval step against the eager steps, the
    same weights and seed: losses, parameters and Adam's state bit for
    bit."""
    from test_torch_graphed_step import assert_runs_equal

    cfg, tbs, gbs, qb = dp_data
    kw = dict(epochs=2, lr=1e-3, seed=4, log_fn=lambda *_: None,
              mesh=dp.make_mesh(2, "cpu"), device="cpu")
    runs, paths = [], []
    for g in (False, True):
        paths.append(str(tmp_path / f"dp{int(g)}"))
        if stage == "neighborhood":
            _, tparams = neigh_pair()
            tt, tq = t_model_configs(cfg, "cpu")
            runs.append(tloop.train_neighborhood(
                tparams, tt, tq, qb, list(tbs), list(tbs[:2]),
                ckpt_path=paths[-1], graphed=g, **kw))
        else:
            _, tp = gossip_pair()
            q = torch.from_numpy(np.random.default_rng(7).standard_normal(
                (gbs[0].node_y.shape[1], 16)).astype(np.float32))
            runs.append(tloop.train_gossip(
                tp, q, list(gbs[:5]), list(gbs[:2]), dropout=dropout,
                ckpt_path=paths[-1], graphed=g, **kw))
    assert runs[0].train_losses[1] != runs[0].train_losses[0]
    assert_runs_equal(*runs, paths)


# ------------------------------------------------------------ prediction
@pytest.mark.parametrize("d", [2, 4])
def test_dp_predict_is_bit_equal_to_single_device(dp_data, rng, d):
    cfg, tbs, gbs, qb = dp_data
    (jt, jq, jparams), tparams = neigh_pair()
    tparams.requires_grad_(False)
    tt, tq = t_model_configs(cfg, "cpu")
    mesh = dp.make_mesh(d, "cpu")
    with torch.inference_mode():
        q_embs = tneigh.embed_queries(tparams, tq, qb.to("cpu"))
    single = tloop.predict_neighborhood_counts(tparams, tt, q_embs,
                                               list(tbs), "cpu")
    got = dp.dp_predict_neighborhood_counts(tparams, tt, q_embs, list(tbs),
                                            mesh)
    np.testing.assert_array_equal(got, single)
    staged = dp.stage_batches_for_dp(list(tbs), mesh)
    assert len(staged) % d == 0
    np.testing.assert_array_equal(dp.dp_predict_neighborhood_counts(
        tparams, tt, q_embs, list(tbs), mesh, staged=staged), single)
    want = jdp.dp_predict_neighborhood_counts(
        jparams, jt, jq, jax_batch(qb), [j_host(b) for b in tbs],
        jdp.make_mesh(d))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-2)
    # gossip
    jp, tp = gossip_pair()
    tp.requires_grad_(False)
    g_embs = rng.standard_normal((gbs[0].node_y.shape[1], 16)).astype(
        np.float32)
    single_g = tloop.predict_gossip_counts(tp, torch.from_numpy(g_embs),
                                           list(gbs), "cpu")
    got_g = dp.dp_predict_gossip_counts(tp, torch.from_numpy(g_embs),
                                        list(gbs), mesh)
    np.testing.assert_array_equal(got_g, single_g)
    want_g = jdp.dp_predict_gossip_counts(
        jp, jnp.asarray(g_embs), [j_host(b) for b in gbs],
        jdp.make_mesh(d))
    np.testing.assert_allclose(got_g, want_g, rtol=1e-3, atol=1e-2)


@pytest.fixture(scope="module")
def request_graphs():
    from desco_tpu_torch.data.synthetic import generate_synthetic

    return generate_synthetic(6, min_size=10, max_size=28, seed=5)


@pytest.mark.parametrize("members", [1, 2], ids=["single", "ensemble"])
def test_counting_service_over_replicas_equals_one_device(request_graphs,
                                                          members):
    neigh = NEIGH if members == 1 else [NEIGH, NEIGH]
    one = CountingService(neigh, GOSSIP, device="cpu")
    four = CountingService(neigh, GOSSIP, device="cpu", n_devices=4)
    assert one.mesh.size == 1 and four.mesh.size == 4
    assert CountingService(NEIGH, device="cpu", n_devices=-1).mesh.size == 1
    assert CountingService(NEIGH, device="cpu", n_devices=0).mesh.size == 1
    a, b = one.count(request_graphs), four.count(request_graphs)
    assert a.refined and b.refined and len(a.verified_rows) > 0
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(b, f.name),
                                      getattr(a, f.name), err_msg=f.name)


# -------------------------------------------------------------------- CLI
def test_parser_default_n_devices_is_all_devices():
    assert build_parser().parse_args([]).n_devices == 0
    assert j_build_parser().parse_args([]).n_devices == 0


def test_main_n_devices_2_trains_on_cpu(tmp_path, capsys):
    from desco_tpu_torch import main as tmain

    from test_torch_cli import TINY_FLAGS

    rc = tmain.main(TINY_FLAGS + [
        "--device", "cpu", "--n_devices", "2", "--train_neigh",
        "--train_gossip", "--test_gossip",
        "--data_root", str(tmp_path / "d"), "--output_dir", str(tmp_path / "o"),
        "--neigh_model_path", str(tmp_path / "n"),
        "--gossip_model_path", str(tmp_path / "g")])
    out = capsys.readouterr().out
    assert rc == 0 and "data-parallel mesh: 2 devices" in out
    assert "done" in out
    assert (tmp_path / "n.best.params.npz").exists()
    assert (tmp_path / "g.best.params.npz").exists()


# ------------------------------------------------------- the training loop
@pytest.mark.parametrize("stage", ["neighborhood", "gossip"])
def test_dp_training_loop_matches_desco_tpu(dp_data, stage):
    """``run_training`` over a D = 2 mesh against desco_tpu's with
    ``mesh=make_mesh(2)``: an odd batch count (one pad batch in the last
    group), the group shuffle and the epoch loss averaged over groups,
    the same weights and seed, dropout 0. Two epochs' train and val
    losses and the final parameters."""
    cfg, tbs, gbs, qb = dp_data
    kw = dict(epochs=2, lr=1e-3, seed=4, log_fn=lambda *_: None)
    if stage == "neighborhood":
        batches = list(tbs)
        (jt, jq, jparams), tparams = neigh_pair()
        want = jloop.train_neighborhood(
            jparams, jt, jq, jax_batch(qb), [j_host(b) for b in batches],
            [j_host(b) for b in batches[:2]], mesh=jdp.make_mesh(2), **kw)
        tt, tq = t_model_configs(cfg, "cpu")
        got = tloop.train_neighborhood(
            tparams, tt, tq, qb, batches, batches[:2],
            mesh=dp.make_mesh(2, "cpu"), device="cpu", **kw)
    else:
        batches = list(gbs[:5])
        q_embs = np.random.default_rng(7).standard_normal(
            (gbs[0].node_y.shape[1], 16)).astype(np.float32)
        jp, tp = gossip_pair()
        want = jloop.train_gossip(
            jp, jnp.asarray(q_embs), [j_host(b) for b in batches],
            [j_host(b) for b in batches[:2]], dropout=0.0,
            mesh=jdp.make_mesh(2), **kw)
        got = tloop.train_gossip(
            tp, torch.from_numpy(q_embs), batches, batches[:2], dropout=0.0,
            mesh=dp.make_mesh(2, "cpu"), device="cpu", **kw)
    assert len(batches) % 2 == 1
    np.testing.assert_allclose(got.train_losses, want.train_losses, rtol=1e-5)
    np.testing.assert_allclose(got.val_losses, want.val_losses, rtol=1e-5)
    final = flatten_params(got.params)
    for key, w in _flatten(want.params).items():
        w = np.asarray(w)
        np.testing.assert_allclose(final[key], w, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=key)
