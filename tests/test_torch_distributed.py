"""desco_tpu_torch's data axis across processes (utils/distributed.py,
parallel/dp.py and parallel/topology.py over a process group, the
training loop and ``main`` under torchrun) against the same replicas in
one process and against desco_tpu, on the CPU.

desco_tpu's multi-process branch puts its ``data`` axis over processes;
here two ranks of a gloo group, started by ``file://`` rendezvous under
the test's temporary directory, hold two or four replicas between them
(tests/torch_dist_worker.py, one process per rank, importing torch and
the port only). Every rank result is held bit for bit against the same
number of replicas in this process and against the other rank; the
reduced gradient of the first step against desco_tpu's ``dp_step_fn``
on its fake host devices within tests/test_torch_dp.py's tolerances
(rtol 1e-4; atol 1e-6 of a tensor's scale, for the gossip 'sum' group
of the sum of its batches' scales). Dropout is 0 where desco_tpu is
compared. Every process has a timeout: the group 60 s, a join 120 s,
after which the children are killed and the test fails."""

import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from desco_tpu.train import loop as jloop
from desco_tpu.train.checkpoint import _flatten
from desco_tpu_torch.models import gossip as tgossip
from desco_tpu_torch.models import neighborhood as tneigh
from desco_tpu_torch.parallel import dp, topology
from desco_tpu_torch.pipeline import model_configs as t_model_configs
from desco_tpu_torch.train import loop as tloop
from desco_tpu_torch.train.checkpoint import flatten_params, params_from_jax
from desco_tpu_torch.utils import distributed

from test_torch_dp import dp_data, j_dp_step  # noqa: F401 (fixture)
from test_torch_grad import (CFG, assert_grads_match, flatten_grads,
                             gossip_pair, neigh_pair)
from test_torch_shmp import jax_batch, one_torch_thread  # noqa: F401
from test_torch_topology import gossip_weights, replica_specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 120.0
# (weighting, D, first batch, dropout): D = 4 takes the last three target
# batches and a pad batch; the last case draws dropout masks per replica
CASES = [("graphs", 2, 0, 0.0), ("graphs", 4, 4, 0.0), ("sum", 2, 0, 0.0),
         ("sum", 4, 2, 0.0), ("sum", 2, 0, 0.3)]
CASE_IDS = ["graphs_two", "graphs_four_with_pad", "sum_two", "sum_four",
            "sum_two_dropout"]


def child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def run_children(cmds, cwd) -> list:
    """Start every command in its own session, wait for all of them for
    at most JOIN_TIMEOUT_S, kill them all on a timeout or a failure, and
    fail; return their (stdout, stderr)."""
    procs = [subprocess.Popen(c, cwd=cwd, env=child_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, start_new_session=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_TIMEOUT_S))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank did not finish in {JOIN_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=10)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"exit {p.returncode}:\n{out[-3000:]}\n" \
                                  f"{err[-3000:]}"
    return outs


def host_flat(jparams) -> dict:
    return {k: np.asarray(v) for k, v in _flatten(jparams).items()}


@pytest.fixture(scope="module")
def dist_run(dp_data, tmp_path_factory):
    """Both ranks' results of every scenario of tests/torch_dist_worker.py
    (one pair of processes for the module), with the job they ran."""
    cfg, tbs, gbs, qb = dp_data
    tmp = tmp_path_factory.mktemp("dist")
    (_, _, jneigh), _ = neigh_pair()
    jgossip, _ = gossip_pair()
    jhalo, halo_q = gossip_weights(seed=3)
    job = dict(
        init_method=f"file://{tmp / 'rendezvous'}", world=2,
        timeout_s=GROUP_TIMEOUT_S, out_dir=str(tmp), cfg=CFG,
        tbs=list(tbs), gbs=list(gbs), qb=qb, neigh=host_flat(jneigh),
        gossip=host_flat(jgossip),
        q_embs=np.random.default_rng(7).standard_normal(
            (gbs[0].node_y.shape[1], 16)).astype(np.float32),
        specs=replica_specs(seed=2), n_graph=2, halo_gossip=host_flat(jhalo),
        halo_q=halo_q, cases=CASES)
    path = tmp / "job.pkl"
    with open(path, "wb") as f:
        pickle.dump(job, f)
    run_children([[sys.executable, WORKER, str(path), str(r)]
                  for r in range(2)], ROOT)
    ranks = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return job, ranks, tmp


def assert_same(a, b, what=""):
    """Nested results (dicts, lists, arrays, floats) equal bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, f"{what}: {a} != {b}"


# ------------------------------------------------------- without a group
@pytest.mark.parametrize("device,local_world,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cuda", 2, 1, "gloo"), ("cuda", 4, 2, "gloo"),
    ("cuda", 2, 2, "nccl"), ("cuda", 4, 8, "nccl")])
def test_backend_rule(device, local_world, cards, want):
    """nccl where every rank of the host owns a card, gloo where ranks
    share a card or run on the CPU."""
    assert distributed.choose_backend(device, local_world, cards) == want


def test_one_process_is_rank_zero_of_one():
    """With no group the helpers are the single-process identities."""
    assert (distributed.rank(), distributed.world()) == (0, 1)
    assert distributed.backend() is None
    t = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(distributed.gather_in_rank_order(t), t)
    distributed.check_replicated(t, "parameters")  # nothing to compare
    with distributed.rank_zero_first():
        pass
    mesh = dp.make_mesh(3, "cpu")
    assert mesh.world == 1 and mesh.local == (0, 1, 2)


def test_stack_batches_of_unpickled_batches(dp_data):
    """A rank's host batches come from a pickle, whose arrays have a
    ``bytes`` base: ``stack_batches`` stacks them as it stacks the
    packer's views (it read ``.base.ndim`` and raised)."""
    from desco_tpu_torch.batch.packed import stack_batches

    _, tbs, _, _ = dp_data
    loaded = pickle.loads(pickle.dumps(list(tbs[:3])))
    assert not isinstance(loaded[0].x.base, np.ndarray)
    got, want = stack_batches(loaded), stack_batches(list(tbs[:3]))
    for name, arr in want.fields():
        np.testing.assert_array_equal(getattr(got, name), arr, err_msg=name)


# ----------------------------------------------------------- the layout
def test_make_mesh_over_ranks(dist_run):
    """D = 4 over two ranks: rank r holds the replicas [2r, 2r + 2) on its
    device, the rest are another rank's; D = 0 is one per rank; a count
    that is not a multiple of the ranks raises; the backend is gloo."""
    _, ranks, _ = dist_run
    for r, res in enumerate(ranks):
        m = res["mesh"]
        assert m["ranks"] == [0, 0, 1, 1]
        assert m["local"] == [2 * r, 2 * r + 1]
        assert [d is not None for d in m["devices"]] == [
            r == 0, r == 0, r == 1, r == 1]
        assert {d for d in m["devices"] if d} == {"cpu"}
        assert m["default_size"] == 2 and m["backend"] == "gloo"
        assert "multiple of the process count" in m["odd_error"]


def test_make_mesh2d_over_ranks(dist_run):
    """desco_tpu's hybrid mesh: the data axis over the ranks (rows [r
    n_data / P, ...)), the graph axis within a rank; n_data not a multiple
    of P gives desco_tpu's fallback grid, whose middle row of 3 x 2
    crosses the ranks (tests/test_torch_halo_ranks.py runs it); a grid of
    fewer slots than a multiple of P raises."""
    _, ranks, _ = dist_run
    for r, res in enumerate(ranks):
        h = res["halo"]
        assert h["rows"] == [r == 0, r == 1]
        assert h["four_rows"] == [r == 0, r == 0, r == 1, r == 1]
        assert h["three_rows"] == [[r == 0, r == 0], [r == 0, r == 1],
                                   [r == 1, r == 1]]
        assert "multiple of the process count" in h["odd_rows_error"]


# ------------------------------------------------------------- DP steps
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_dp_steps_over_ranks_equal_one_process(dp_data, dist_run, case):
    """Three DP steps over two ranks, eager and graphed, against the same
    D replicas in one process: losses, flags, the first reduced gradient,
    the final parameters and Adam's first moment bit for bit on both
    ranks; without dropout the first reduced gradient against desco_tpu's
    ``dp_step_fn``."""
    cfg, tbs, gbs, qb = dp_data
    job, ranks, _ = dist_run
    kind, d, first, dropout = case
    batches = dp.pad_batches_to_multiple(
        list((tbs if kind == "graphs" else gbs)[first:first + d]), d)
    mesh = dp.make_mesh(d, "cpu")
    group = dp.place_batches(batches, mesh, training=True)
    q = torch.from_numpy(job["q_embs"])
    if kind == "graphs":
        (jt, jq, jparams), _ = neigh_pair()
        tt, tq = t_model_configs(cfg, "cpu")
        loss_fn = tloop.neighborhood_loss_fn(tt, tq, qb.to("cpu"))
        flat0 = job["neigh"]
    else:
        jparams, _ = gossip_pair()
        loss_fn = tloop.gossip_loss_fn(dropout, q)
        flat0 = job["gossip"]
    params = params_from_jax(flat0)
    opt = tloop.make_adam(params)
    step = dp.DPStep(loss_fn, opt, mesh, kind)
    gens = dp.replica_generators(mesh, 3)
    losses, oks, grad1 = [], [], None
    for i in range(3):
        dp.reseed_replica_generators(gens, 3 + i)
        loss, ok = step(params, group, 1e-3, gens)
        losses.append(float(loss))
        oks.append(bool(ok))
        if grad1 is None:
            grad1 = opt.grad.numpy().copy()
    want = {"losses": losses, "oks": oks, "grad1": grad1,
            "flat": opt.flat.numpy(), "mu": opt.mu.numpy()}
    assert all(oks) and losses[0] != losses[2]
    for r, res in enumerate(ranks):
        for graphed in (False, True):
            assert_same(res["steps"][case][graphed], want,
                        f"rank {r} graphed={graphed}")
    if dropout:
        return
    # the reduced gradient against desco_tpu's dp_step_fn
    tparams = params_from_jax(flat0)
    tloop.make_adam(tparams).grad.copy_(torch.from_numpy(grad1))
    if kind == "graphs":
        _, jgrads = j_dp_step(
            jloop.neighborhood_loss_fn(jt, jq, jax_batch(qb)), jparams,
            batches, d, "graphs")
        assert_grads_match(tparams, jgrads, min_nonzero=10)
        return
    _, jgrads = j_dp_step(jloop.gossip_loss_fn(0.0, jnp.asarray(
        job["q_embs"])), jparams, batches, d, "sum")
    scales = {}
    for b in batches:
        single = params_from_jax(flat0)
        tgossip.gossip_loss(single, b.to("cpu", training=True), q).backward()
        for key, g in flatten_grads(single).items():
            scales[key] = scales.get(key, 0.0) + float(np.abs(g).max())
    got = flatten_grads(tparams)
    for key, w in _flatten(jgrads).items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4,
                                   atol=1e-6 * max(scales[key], 1e-30),
                                   err_msg=key)
    assert sum(s > 0 for s in scales.values()) >= 10


# ----------------------------------------------------------- DP predicts
@pytest.mark.parametrize("d", [2, 4])
def test_dp_predicts_over_ranks_equal_one_device(dp_data, dist_run, d):
    """Both stages' DP predicts over two ranks: every rank returns the
    single-device predict's array, bit for bit."""
    cfg, tbs, gbs, qb = dp_data
    job, ranks, _ = dist_run
    tt, tq = t_model_configs(cfg, "cpu")
    params = params_from_jax(job["neigh"]).requires_grad_(False)
    with torch.inference_mode():
        q_embs = tneigh.embed_queries(params, tq, qb.to("cpu"))
    neigh = tloop.predict_neighborhood_counts(params, tt, q_embs, list(tbs),
                                              "cpu")
    gparams = params_from_jax(job["gossip"]).requires_grad_(False)
    gossip = tloop.predict_gossip_counts(
        gparams, torch.from_numpy(job["q_embs"]), list(gbs), "cpu")
    for res in ranks:
        np.testing.assert_array_equal(res["predict"][d]["neigh"], neigh)
        np.testing.assert_array_equal(res["predict"][d]["gossip"], gossip)


# --------------------------------------------------------------- DP x halo
def test_dp_halo_over_ranks_equals_the_grid_in_one_process(dist_run):
    """The 2 x 2 DP x halo grid with its rows on two ranks: the composed
    loss and gradient, and two calls of the step (dropout 0.1) eager and
    graphed, bit-equal to the in-process grid on both ranks."""
    job, ranks, _ = dist_run
    cpu = [torch.device("cpu")]
    parts = topology.harmonized_partitions(job["specs"], job["n_graph"],
                                           n_types=2)
    replicas = topology.place_replicas(
        topology.stack_partitions(parts),
        topology.make_mesh2d(2, job["n_graph"], devices=cpu))
    q = torch.from_numpy(job["halo_q"])
    loss, flat = topology.dp_halo_gossip_loss_and_grads(
        params_from_jax(job["halo_gossip"]), replicas, q)
    params = params_from_jax(job["halo_gossip"])
    opt = tloop.make_adam(params)
    step = topology.dp_halo_gossip_step_fn(opt, dropout=0.1)
    calls = []
    for seed in (4, 5):
        s_loss, ok = step(params, replicas, q, 1e-3, seed=seed)
        calls.append([float(s_loss), bool(ok)] + [
            t.numpy().copy() for t in (opt.grad, opt.flat, opt.mu, opt.nu)])
    assert all(c[1] for c in calls)
    for r, res in enumerate(ranks):
        h = res["halo"]
        assert h["loss"] == float(loss)
        np.testing.assert_array_equal(h["flat"], flat.numpy())
        for graphed in (False, True):
            assert_same(h[graphed], calls, f"rank {r} graphed={graphed}")


# ------------------------------------------------------ the training loop
@pytest.mark.parametrize("stage", ["neigh", "gossip"])
def test_training_over_ranks_equals_one_process(dp_data, dist_run, stage):
    """``run_training`` over a D = 2 mesh of two ranks (the graphed DP step
    in two parts), 2 epochs, the gossip's at dropout 0.01: train and val
    losses and final parameters bit-equal to D = 2 in one process on both
    ranks; rank 0 alone wrote its checkpoints."""
    cfg, tbs, gbs, qb = dp_data
    job, ranks, tmp = dist_run
    kw = dict(epochs=2, lr=1e-3, seed=4, log_fn=lambda *_: None,
              mesh=dp.make_mesh(2, "cpu"), device="cpu")
    if stage == "neigh":
        tt, tq = t_model_configs(cfg, "cpu")
        res = tloop.train_neighborhood(
            params_from_jax(job["neigh"]), tt, tq, qb, list(tbs),
            list(tbs[:2]), **kw)
    else:
        res = tloop.train_gossip(
            params_from_jax(job["gossip"]), torch.from_numpy(job["q_embs"]),
            list(gbs[:5]), list(gbs[:2]), dropout=0.01, **kw)
    want = {"train": res.train_losses, "val": res.val_losses,
            "params": flatten_params(res.params)}
    for r, got in enumerate(ranks):
        assert_same(got["training"][stage], want, f"rank {r}")
    assert (tmp / f"ckpt_rank0_{stage}.best.params.npz").exists()
    assert (tmp / f"ckpt_rank0_{stage}.last.opt.npz").exists()
    assert not list(tmp.glob("ckpt_rank1_*"))


# -------------------------------------------------------------------- CLI
def test_main_under_torchrun_equals_one_process(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    desco_tpu_torch.main --n_devices 2 --device cpu``, one epoch per
    stage: rank 0 prints the group's mesh and writes one set of
    checkpoints and outputs, equal to the one-process ``--n_devices 2``
    run's."""
    from desco_tpu_torch import main as tmain

    from test_torch_cli import TINY_FLAGS

    def flags(tag):
        return TINY_FLAGS + [
            "--neigh_epoch_num", "1", "--gossip_epoch_num", "1",
            "--device", "cpu", "--n_devices", "2", "--train_neigh",
            "--train_gossip", "--test_gossip",
            "--data_root", str(tmp_path / "data"),
            "--output_dir", str(tmp_path / f"out_{tag}"),
            "--neigh_model_path", str(tmp_path / f"n_{tag}"),
            "--gossip_model_path", str(tmp_path / f"g_{tag}")]

    assert tmain.main(flags("one")) == 0
    [(out, _)] = run_children([[
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", "2", "-m", "desco_tpu_torch.main",
        *flags("two")]], ROOT)
    assert out.count("data-parallel mesh: 2 devices over 2 processes "
                     "(backend gloo)") == 1
    assert "process group: rank 0 of 2, backend gloo" in out
    assert "process group: rank 1 of 2, backend gloo" in out
    assert out.count("\ndone\n") == 1
    for stage in ("n", "g"):
        for kind in (".best.params.npz", ".last.params.npz",
                     ".last.opt.npz"):
            one = np.load(tmp_path / f"{stage}_one{kind}")
            two = np.load(tmp_path / f"{stage}_two{kind}")
            assert sorted(one.files) == sorted(two.files)
            for key in one.files:
                np.testing.assert_array_equal(two[key], one[key],
                                              err_msg=f"{stage}{kind} {key}")
    names = sorted(p.name for p in (tmp_path / "out_one").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "out_two").iterdir())
    for name in names:
        if name.endswith(".csv") or name.startswith("analyze"):
            assert ((tmp_path / "out_two" / name).read_text()
                    == (tmp_path / "out_one" / name).read_text()), name
