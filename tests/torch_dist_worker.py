"""One rank of a process group on the CPU, for
tests/test_torch_distributed.py (the data axis across ranks) and
tests/test_torch_halo_ranks.py (the halo graph axis across ranks).

    python tests/torch_dist_worker.py JOB RANK

JOB is a pickle the test wrote: the rendezvous (``init_method``, a
``file://`` path under the test's temporary directory), the world size,
the group's timeout, the device (the CPU by default; ``"cuda"`` for
tests/test_torch_cuda.py), the scenario (``"dp"`` by default,
``"halo_ranks"``, ``"grid_over_three"``, ``"halo_card"``), the inputs (host batches, weights in desco_tpu's
flat layout, query embeddings, halo partitions) and where to write this
rank's results (a pickle of numpy arrays and plain values). It imports
torch and desco_tpu_torch only: never the test module, which imports
JAX, nor tests/conftest.py.
"""

import os
import pickle
import sys

import torch

from desco_tpu_torch.models import neighborhood
from desco_tpu_torch.parallel import dp, halo, topology
from desco_tpu_torch.pipeline import PipelineConfig, model_configs
from desco_tpu_torch.train import loop
from desco_tpu_torch.train.checkpoint import flatten_params, params_from_jax
from desco_tpu_torch.utils import distributed
from desco_tpu_torch.utils.cuda_graphs import GraphedStep

CPU = torch.device("cpu")


def arr(t):
    return t.detach().cpu().numpy().copy()


def dp_steps(job, case):
    """Three DP steps, eager and graphed (static buffers on the CPU):
    losses, flags, the first step's reduced gradient, the final
    parameters."""
    kind, d, first, dropout = case
    batches = dp.pad_batches_to_multiple(
        list(job["tbs" if kind == "graphs" else "gbs"][first:first + d]), d)
    mesh = dp.make_mesh(d, "cpu")
    group = dp.place_batches(batches, mesh, training=True)
    if kind == "graphs":
        tt, tq = model_configs(PipelineConfig(**job["cfg"]), "cpu")
        loss_fn = loop.neighborhood_loss_fn(tt, tq, job["qb"].to("cpu"))
        flat0 = job["neigh"]
    else:
        loss_fn = loop.gossip_loss_fn(dropout,
                                      torch.from_numpy(job["q_embs"]))
        flat0 = job["gossip"]
    out = {}
    for graphed in (False, True):
        params = params_from_jax(flat0)
        opt = loop.make_adam(params)
        step = dp.DPStep(loss_fn, opt, mesh, kind, graphed=graphed)
        gens = dp.replica_generators(mesh, 3)
        losses, oks, grad1 = [], [], None
        for i in range(3):
            dp.reseed_replica_generators(gens, 3 + i)
            loss, ok = step(params, group, 1e-3, gens)
            losses.append(float(loss))
            oks.append(bool(ok))
            if grad1 is None:
                grad1 = arr(opt.grad)
        out[graphed] = {"losses": losses, "oks": oks, "grad1": grad1,
                        "flat": arr(opt.flat), "mu": arr(opt.mu)}
    return out


def predicts(job, d):
    """Both stages' DP predicts over ``d`` replicas."""
    mesh = dp.make_mesh(d, "cpu")
    tt, tq = model_configs(PipelineConfig(**job["cfg"]), "cpu")
    params = params_from_jax(job["neigh"]).requires_grad_(False)
    with torch.inference_mode():
        q_embs = neighborhood.embed_queries(params, tq,
                                            job["qb"].to("cpu"))
    gparams = params_from_jax(job["gossip"]).requires_grad_(False)
    return {
        "neigh": dp.dp_predict_neighborhood_counts(
            params, tt, q_embs, list(job["tbs"]), mesh),
        "gossip": dp.dp_predict_gossip_counts(
            gparams, torch.from_numpy(job["q_embs"]), list(job["gbs"]), mesh)}


def dp_halo(job):
    """The 2 x 2 DP x halo grid, its rows on the ranks: the layout, the
    composed loss and gradient, and two calls of the step eager and
    graphed at dropout 0.1."""
    n_graph = job["n_graph"]
    parts = topology.harmonized_partitions(job["specs"], n_graph, n_types=2)
    mesh = topology.make_mesh2d(2, n_graph, devices=[CPU])
    replicas = topology.place_replicas(topology.stack_partitions(parts),
                                       mesh)
    q = torch.from_numpy(job["halo_q"])
    out = {"rows": [row[0] is not None for row in mesh.devices],
           "four_rows": [row[0] is not None for row in
                         topology.make_mesh2d(4, 1, devices=[CPU]).devices]}
    out["three_rows"] = [[d is not None for d in row] for row in
                         topology.make_mesh2d(3, n_graph,
                                              devices=[CPU]).devices]
    try:
        topology.make_mesh2d(3, 1, devices=[CPU])
        out["odd_rows_error"] = None
    except ValueError as e:
        out["odd_rows_error"] = str(e)
    params = params_from_jax(job["halo_gossip"])
    loss, flat = topology.dp_halo_gossip_loss_and_grads(params, replicas, q)
    out["loss"], out["flat"] = float(loss), arr(flat)
    for graphed in (False, True):
        params = params_from_jax(job["halo_gossip"])
        opt = loop.make_adam(params)
        step = topology.dp_halo_gossip_step_fn(opt, dropout=0.1,
                                               graphed=graphed)
        calls = []
        for seed in (4, 5):
            loss, ok = step(params, replicas, q, 1e-3, seed=seed)
            calls.append([float(loss), bool(ok), arr(opt.grad),
                          arr(opt.flat), arr(opt.mu), arr(opt.nu)])
        out[graphed] = calls
    return out


def mesh_layout(job):
    mesh = dp.make_mesh(4, "cpu")
    out = {"ranks": list(mesh.ranks), "local": list(mesh.local),
           "devices": [None if d is None else str(d) for d in mesh.devices],
           "default_size": dp.make_mesh(0, "cpu").size,
           "backend": distributed.backend()}
    try:
        dp.make_mesh(3, "cpu")
        out["odd_error"] = None
    except ValueError as e:
        out["odd_error"] = str(e)
    return out


def training(job):
    """``run_training`` over a D = 2 mesh of the two ranks, 2 epochs of each
    stage (the gossip's at dropout 0.01), each rank given its own
    checkpoint path: rank 0 alone writes."""
    cfg = PipelineConfig(**job["cfg"])
    tt, tq = model_configs(cfg, "cpu")
    mesh = dp.make_mesh(2, "cpu")
    kw = dict(epochs=2, lr=1e-3, seed=4, log_fn=lambda *_: None,
              mesh=mesh, device="cpu")
    prefix = os.path.join(job["out_dir"], f"ckpt_rank{distributed.rank()}")
    res = loop.train_neighborhood(
        params_from_jax(job["neigh"]), tt, tq, job["qb"], list(job["tbs"]),
        list(job["tbs"][:2]), ckpt_path=prefix + "_neigh", **kw)
    gres = loop.train_gossip(
        params_from_jax(job["gossip"]), torch.from_numpy(job["q_embs"]),
        list(job["gbs"][:5]), list(job["gbs"][:2]), dropout=0.01,
        ckpt_path=prefix + "_gossip", **kw)
    return {stage: {"train": r.train_losses, "val": r.val_losses,
                    "params": flatten_params(r.params)}
            for stage, r in (("neigh", res), ("gossip", gres))}


def step_calls(step, params, opt, place, q, seeds) -> list:
    """Calls of a placed train step: per call the loss, the flag, the
    reduced gradient, the parameters and Adam's moments."""
    calls = []
    for seed in seeds:
        loss, ok = step(params, place, q, 1e-3, seed=seed)
        calls.append([float(loss), bool(ok), arr(opt.grad), arr(opt.flat),
                      arr(opt.mu), arr(opt.nu)])
    return calls


def chain_of(step) -> list:
    """A graphed step's chain (utils/cuda_graphs.GraphedStep): its split
    points' kinds and groups, in order."""
    return [(k[0], k[1]) for k in step.held["step"].sequence]


def grid_steps(job, n_data, n_graph) -> dict:
    """The DP x halo grid over the ranks: the layout, the composed loss and
    gradient, and two calls of the step at dropout 0.1, eager (and
    graphed: a chain split at its collectives, its split points kept)."""
    mesh = topology.make_mesh2d(n_data, n_graph, devices=[CPU])
    replicas = topology.place_replicas(
        topology.stack_partitions(job["grid_parts"]), mesh)
    q = torch.from_numpy(job["halo_q"])
    out = {"ranks": mesh.ranks,
           "local": [[d is not None for d in row] for row in mesh.devices]}
    loss, flat = topology.dp_halo_gossip_loss_and_grads(
        params_from_jax(job["halo_gossip"]), replicas, q)
    out["loss"], out["flat"] = float(loss), arr(flat)
    for graphed in (False, True):
        params = params_from_jax(job["halo_gossip"])
        opt = loop.make_adam(params)
        step = topology.dp_halo_gossip_step_fn(opt, dropout=0.1,
                                               graphed=graphed)
        out[graphed] = step_calls(step, params, opt, replicas, q, (4, 5))
        if graphed:
            out["chain"] = chain_of(step)
    return out


def halo_ranks(job) -> dict:
    """The halo graph axis across the two ranks: ``make_mesh2d``'s
    layouts and its raise, ``exchange_blocks`` and its backward, the
    4-shard gossip loss (scalar and per slot), the slots' gradient rows
    and two calls of ``halo_gossip_step_fn`` at dropout 0 and 0.1, eager
    and graphed; the 3 x 2 DP x halo grid; the 1 x 2 SHMP forward (SAGE,
    PNA)."""
    out = {"mesh": {shape: topology.make_mesh2d(*shape, devices=[CPU])
                    for shape in ((1, 4), (3, 2), (2, 2))}}
    out["mesh"] = {k: (m.ranks, [[d is not None for d in row]
                                 for row in m.devices])
                   for k, m in out["mesh"].items()}
    try:
        topology.make_mesh2d(3, 1, devices=[CPU])
        out["odd_error"] = None
    except ValueError as e:
        out["odd_error"] = str(e)
    # exchange_blocks: block j to rank j, and the cotangents back
    r = distributed.rank()
    send = (torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
            + 100.0 * r).requires_grad_(True)
    got = distributed.exchange_blocks(send)
    got.backward(torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
                 * (r + 2.0))
    out["exchange"] = {"got": arr(got), "grad": arr(send.grad)}
    # with counts: 2 blocks to the other rank, none to this one
    send = (torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
            + 100.0 * r).requires_grad_(True)
    counts = [2 if q != r else 0 for q in range(2)]
    got = distributed.exchange_blocks(send, counts=(counts, counts))
    got.backward(torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
                 * (r + 2.0))
    out["exchange_counts"] = {"got": arr(got), "grad": arr(send.grad)}
    # ranks that leave a rank no slot, or name a rank outside the group
    out["bad_ranks"] = {}
    for bad in ((0, 0, 0, 0), (0, 0, 1, 2)):
        try:
            halo.place_shards(job["halo_part"], [CPU], ranks=bad)
            out["bad_ranks"][bad] = None
        except ValueError as e:
            out["bad_ranks"][bad] = str(e)
    # four shards, two per rank
    shards = topology.place_replicas(
        topology.stack_partitions([job["halo_part"]]),
        topology.make_mesh2d(1, 4, devices=[CPU]))[0]
    q = torch.from_numpy(job["halo_q"])
    params = params_from_jax(job["halo_gossip"])
    out["held"] = [sh is not None for sh in shards]
    out["loss"] = float(halo.halo_gossip_loss(params, shards, q).detach())
    out["sums"] = [float(s) for s in halo._slot_sums(
        halo.shard_params(params, torch.float32, shards), shards, q, 0.0,
        False, None)]
    out["terms"] = arr(halo.slot_terms(params, shards, q))
    for dropout in (0.0, 0.1):
        for graphed in (False, True):
            params = params_from_jax(job["halo_gossip"])
            opt = loop.make_adam(params)
            step = halo.halo_gossip_step_fn(opt, dropout=dropout,
                                            graphed=graphed)
            out["step", dropout, graphed] = step_calls(
                step, params, opt, shards, q, (4, 5))
            if graphed:
                out["chain", dropout] = chain_of(step)
    out["grid"] = grid_steps(job, 3, 2)
    # serving stays per process: the halo serve inside the group places
    # every shard on this rank and serves the whole graph
    graph, x_all = job["serve"]
    with torch.inference_mode():
        out["serve"] = halo.serve_gossip_counts(
            params_from_jax(job["halo_gossip"]).requires_grad_(False), graph,
            x_all, q, n_devices=4, device="cpu")
    # the sharded SHMP forward on a 1 x 2 grid over the ranks
    for conv, (cfg, flat0, part) in job["towers"].items():
        reps = topology.place_replicas(
            topology.stack_partitions([part]),
            topology.make_mesh2d(1, 2, devices=[CPU]))
        tparams = params_from_jax(flat0)
        for graphed in (False, True):
            fwd = topology.dp_halo_shmp_forward(cfg, graphed=graphed)
            with torch.inference_mode():
                calls = [fwd(tparams, reps)[0] for _ in range(2)]
            out["shmp", conv, graphed] = [
                [None if e is None else arr(e) for e in embs]
                for embs in calls]
            if graphed:
                out["shmp_chain", conv] = chain_of(fwd)
    out["chain_checks"] = chain_checks()
    return out


def chain_checks() -> dict:
    """A chained step's raises across the ranks (utils/cuda_graphs
    .GraphedStep on the CPU): a call that issues more or fewer
    collectives than the first, a collective inside a piece that is not
    a split point (a barrier, the parameters' check), and
    ``check_sequence`` given lists that differ between the ranks. Each
    raises on every rank alike, before any collective would wait."""
    r = distributed.rank()
    n = {"exchanges": 2}

    def body(b):
        x = b[0]
        for _ in range(n["exchanges"]):
            x = distributed.exchange_blocks(x) * 2.0
        return x

    out = {}
    step = GraphedStep(body, (torch.zeros(2, 3),), capture=False)
    first = step((torch.arange(6.0).reshape(2, 3) + 10.0 * r,))
    out["first"] = arr(first)
    out["sequence"] = [(k[0], k[1]) for k in step.sequence]
    for name, count in (("more", 3), ("fewer", 1)):
        n["exchanges"] = count
        try:
            step((torch.zeros(2, 3),))
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
    n["exchanges"] = 2
    out["again"] = arr(step((torch.arange(6.0).reshape(2, 3) + 10.0 * r,)))
    for name, stray in (("barrier", distributed.barrier),
                        ("check", lambda: distributed.check_replicated(
                            torch.ones(2), "parameters"))):
        def stray_body(b, stray=stray):
            stray()
            return b[0]
        try:
            GraphedStep(stray_body, (torch.zeros(2),), capture=False)(
                (torch.zeros(2),))
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
    keys = [("all_to_all", (0, 1), ((1, 1), (1, 1)), (2, 3 + r),
             "torch.float32", (2, 3 + r))]
    try:
        distributed.check_sequence(keys)
        out["ranks_differ"] = None
    except RuntimeError as e:
        out["ranks_differ"] = str(e)
    distributed.check_sequence([k[:3] + ((2, 3),) + k[4:5] + ((2, 3),)
                                for k in keys])
    return out


def halo_card(job) -> dict:
    """The 4-shard halo gossip step over the ranks on ``job["device"]``
    (the card in tests/test_torch_cuda.py): two calls at dropout 0 and
    0.1, eager and graphed (a chain of CUDA graphs), and each graphed
    chain's (graphs, split points)."""
    dev = distributed.rank_device(job["device"])
    shards = topology.place_replicas(
        topology.stack_partitions([job["halo_part"]]),
        topology.make_mesh2d(1, 4, devices=[dev]))[0]
    q = torch.from_numpy(job["halo_q"]).to(dev)
    out = {}
    for dropout in (0.0, 0.1):
        for graphed in (False, True):
            params = params_from_jax(job["halo_gossip"]).to(dev)
            opt = loop.make_adam(params)
            step = halo.halo_gossip_step_fn(opt, dropout=dropout,
                                            graphed=graphed)
            out["step", dropout, graphed] = step_calls(
                step, params, opt, shards, q, (4, 5))
            if graphed:
                chained = step.held["step"]
                out["chain", dropout] = (len(chained.graphs),
                                         len(chained.sequence))
    return out


SCENARIOS = {
    "dp": lambda job: {
        "mesh": mesh_layout(job),
        "steps": {case: dp_steps(job, case) for case in job["cases"]},
        "predict": {d: predicts(job, d) for d in (2, 4)},
        "halo": dp_halo(job),
        "training": training(job)},
    "halo_ranks": halo_ranks,
    "halo_card": halo_card,
    "grid_over_three": lambda job: grid_steps(job, 2, 3)}


def main():
    with open(sys.argv[1], "rb") as f:
        job = pickle.load(f)
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    distributed.init(job.get("device", "cpu"),
                     init_method=job["init_method"], rank=rank,
                     world_size=job["world"], timeout_s=job["timeout_s"],
                     log_fn=lambda *_: None)
    try:
        out = SCENARIOS[job.get("scenario", "dp")](job)
    finally:
        distributed.shutdown()
    with open(os.path.join(job["out_dir"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
