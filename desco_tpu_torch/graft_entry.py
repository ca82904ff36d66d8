"""Entry points — the port of the repo's root ``__graft_entry__.py``.

``entry()``: a forward function and its arguments on the flagship model
(SHMP neighborhood counting: a canonical-neighborhood batch and the query
batch in, de-logged per-(neighborhood, query) counts out) at tiny shapes.

``dryrun_multichip(n)``: desco_tpu's multi-chip drill at tiny shapes over
``n`` data-parallel replicas (parallel/dp.py): one DP training step of
both stages, DP serving of both stages against one device (equal bits),
the halo-sharded SHMP forward and its overlap proof, a halo gossip train
step, and for n >= 4 the composed ``data`` x ``graph`` step
(parallel/topology.py). Both run on CUDA unless ``device="cpu"`` is
given; the replicas cycle over the visible GPUs, so any ``n`` runs on one
card.

    python -m desco_tpu_torch.graft_entry [--n 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import dataclasses

import numpy as np
import torch


def _tiny_setup(device, n_graphs: int = 8, seed: int = 0):
    from .batch.build import neighborhood_sample, query_sample
    from .batch.packed import auto_capacities, pack_samples
    from .data.synthetic import generate_synthetic
    from .graph.atlas import gen_queries, gen_query_ids
    from .graph.canonical import extract_all_neighborhoods
    from .models import neighborhood as neigh_mod
    from .models.shmp_gnn import neighborhood_target_config, query_config
    from .ops.cuda_segment import default_agg_mode

    graphs = generate_synthetic(n_graphs, min_size=8, max_size=14, seed=seed)
    queries = gen_queries(gen_query_ids([3]))
    n_q = len(queries)
    neighs, _, _ = extract_all_neighborhoods(graphs, depth=3)
    rng = np.random.default_rng(0)
    samples = [neighborhood_sample(nb, y=rng.random(n_q).astype(np.float32))
               for nb in neighs]
    qs = [query_sample(q) for q in queries]
    [qb] = pack_samples(qs, *auto_capacities(qs, g_cap=len(qs)))
    tgt_cfg = neighborhood_target_config(
        layer_num=2, hidden_dim=16, output_dim=16,
        agg_mode=default_agg_mode(device))
    qry_cfg = query_config(layer_num=2, hidden_dim=16, output_dim=16)
    params = neigh_mod.init_neighborhood_model(
        tgt_cfg, qry_cfg, torch.Generator().manual_seed(seed)).to(device)
    return graphs, samples, qb, tgt_cfg, qry_cfg, params, n_q


def entry(device=None):
    """(fn, example_args): the flagship forward and its inputs on
    ``device`` (default CUDA)."""
    from .batch.packed import auto_capacities, pack_samples
    from .models import neighborhood as neigh_mod
    from .utils.device import resolve_device

    device = resolve_device(device)
    _, samples, qb, tgt_cfg, qry_cfg, params, n_q = _tiny_setup(device)
    batch = pack_samples(samples, *auto_capacities(samples, g_cap=16),
                         n_queries=n_q)[0]

    def fn(params, batch, qb):
        with torch.inference_mode():
            return neigh_mod.predict_counts(params, tgt_cfg, qry_cfg, batch,
                                            qb)

    return fn, (params.requires_grad_(False), batch.to(device),
                qb.to(device))


def _gossip_samples(graphs, n_q: int, rng):
    from .batch.build import gossip_sample

    return [gossip_sample(g, rng.random((g.n_nodes, n_q)).astype(np.float32),
                          rng.random((g.n_nodes, n_q)).astype(np.float32))
            for g in graphs]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One pass of desco_tpu's multi-chip drill over ``n_devices``
    replicas (see module docs); raises on a failed check and returns the
    losses it printed."""
    from .batch.packed import auto_capacities, pack_samples
    from .models import gossip as gossip_mod
    from .models import neighborhood as neigh_mod
    from .parallel import dp, halo, topology
    from .parallel.overlap_check import check_halo_overlap
    from .train import loop
    from .utils.device import resolve_device

    device = resolve_device(device)
    mesh = dp.make_mesh(n_devices, device)
    graphs, samples, qb, tgt_cfg, qry_cfg, params, n_q = _tiny_setup(
        device, n_graphs=2 * n_devices)
    qb_dev = qb.to(device)
    out = {}

    # ---- neighborhood DP training step
    batches = pack_samples(samples, *auto_capacities(samples, g_cap=8),
                           n_queries=n_q, need_bwd_perm=True)
    batches = dp.pad_batches_to_multiple(batches, n_devices)[:n_devices]
    opt = loop.make_adam(params)
    step = dp.DPStep(loop.neighborhood_loss_fn(tgt_cfg, qry_cfg, qb_dev),
                     opt, mesh, weight_kind="graphs")
    loss, _ = step(params, dp.place_batches(batches, mesh, training=True),
                   1e-3, dp.replica_generators(mesh, 0))
    out["neighborhood_loss"] = float(loss)
    assert np.isfinite(out["neighborhood_loss"]), \
        "neighborhood DP loss not finite"
    params.requires_grad_(False)

    # ---- gossip DP training step
    rng = np.random.default_rng(1)
    gsamples = _gossip_samples(graphs, n_q, rng)
    gbatches = pack_samples(gsamples, *auto_capacities(gsamples, g_cap=4),
                            n_queries=n_q, need_bwd_perm=True)
    gbatches = dp.pad_batches_to_multiple(gbatches, n_devices)[:n_devices]
    with torch.inference_mode():
        query_embs = neigh_mod.embed_queries(params, qry_cfg, qb_dev)
    query_embs = query_embs[:, :16].clone()
    gparams = gossip_mod.init_gossip_model(
        hidden_dim=16, emb_channels=16,
        generator=torch.Generator().manual_seed(1)).to(device)
    gopt = loop.make_adam(gparams)
    gstep = dp.DPStep(loop.gossip_loss_fn(0.01, query_embs), gopt, mesh,
                      weight_kind="sum")
    gloss, _ = gstep(gparams, dp.place_batches(gbatches, mesh,
                                               training=True),
                     1e-3, dp.replica_generators(mesh, 2))
    out["gossip_loss"] = float(gloss)
    assert np.isfinite(out["gossip_loss"]), "gossip DP loss not finite"
    gparams.requires_grad_(False)

    # ---- DP serving of both stages: the same bits as one device
    with torch.inference_mode():
        q_embs = neigh_mod.embed_queries(params, qry_cfg, qb_dev)
    single = loop.predict_neighborhood_counts(params, tgt_cfg, q_embs,
                                              batches, device)
    dp_counts = dp.dp_predict_neighborhood_counts(params, tgt_cfg, q_embs,
                                                  batches, mesh)
    assert np.array_equal(dp_counts, single), "DP serving mismatch"
    single_g = loop.predict_gossip_counts(gparams, query_embs, gbatches,
                                          device)
    dp_g = dp.dp_predict_gossip_counts(gparams, query_embs, gbatches, mesh)
    assert np.array_equal(dp_g, single_g), "DP gossip serving mismatch"

    # ---- the halo-sharded (graph-axis) SHMP forward
    s = max(samples, key=lambda s: s.n_nodes)
    part = halo.partition_typed_graph(
        s.n_nodes, s.node_type, s.x, s.edge_src, s.edge_dst, s.edge_type,
        n_devices, n_types=tgt_cfg.n_edge_types)
    shards = halo.place_shards(part, halo.shard_devices(n_devices, device))
    with torch.inference_mode():
        hout = halo.halo_shmp_core(params["target"], tgt_cfg, shards)
    assert all(bool(torch.isfinite(h).all()) for h in hout), \
        "halo forward not finite"
    out["halo_forward"] = [tuple(h.shape) for h in hout]

    # ---- the overlap proof: no interior stream of a layer reads that
    # layer's pull exchange. It taints tensors through the dispatcher,
    # which the card's ctypes launches bypass, so it reads the same
    # partition's shards on the CPU
    cpu_shards = halo.place_shards(part, [torch.device("cpu")])
    cpu_target = copy.deepcopy(params["target"]).to("cpu")
    cpu_cfg = dataclasses.replace(tgt_cfg, agg_mode="aggregate_first")
    rep = check_halo_overlap(
        lambda: halo.halo_shmp_core(cpu_target, cpu_cfg, cpu_shards))
    assert rep.ok, f"halo overlap structure violated: {rep.summary()}"

    # ---- the halo-sharded gossip train step
    gbig = max(graphs, key=lambda g: g.n_nodes)
    [hs] = _gossip_samples([gbig], n_q, rng)
    hpart = halo.partition_typed_graph(
        gbig.n_nodes, hs.node_type, hs.x, hs.edge_src, hs.edge_dst,
        hs.edge_type, n_devices, node_y=hs.node_y, n_types=2)
    hshards = halo.place_shards(hpart, halo.shard_devices(n_devices, device))
    hparams = gparams.requires_grad_(True)
    hstep = halo.halo_gossip_step_fn(loop.make_adam(hparams))
    hloss, _ = hstep(hparams, hshards, query_embs, 1e-3, seed=7)
    out["halo_train_loss"] = float(hloss)
    assert np.isfinite(out["halo_train_loss"]), \
        "halo gossip train loss not finite"

    # ---- the composed data x graph step: each DP replica trains on its
    # own halo-partitioned graph; gradients cross the halo exchanges and
    # one reduction over the replicas
    out["dp_halo_loss"] = float("nan")
    if n_devices >= 4 and n_devices % 2 == 0:
        n_g = n_devices // 2
        gs = sorted(graphs, key=lambda g: -g.n_nodes)[:2]
        specs = [dict(n_nodes=g.n_nodes, node_type=s2.node_type, x=s2.x,
                      edge_src=s2.edge_src, edge_dst=s2.edge_dst,
                      edge_type=s2.edge_type, node_y=s2.node_y)
                 for g, s2 in zip(gs, _gossip_samples(gs, n_q, rng))]
        mesh2 = topology.make_mesh2d(2, n_g, devices=list(mesh.devices))
        replicas = topology.place_replicas(topology.stack_partitions(
            topology.harmonized_partitions(specs, n_g, n_types=2)), mesh2)
        cstep = topology.dp_halo_gossip_step_fn(loop.make_adam(hparams))
        closs, _ = cstep(hparams, replicas, query_embs, 1e-3, seed=8)
        out["dp_halo_loss"] = float(closs)
        assert np.isfinite(out["dp_halo_loss"]), \
            "2-axis dp x halo loss not finite"

    print(f"dryrun_multichip({n_devices}) on {device}: neighborhood loss "
          f"{out['neighborhood_loss']:.4f}, gossip loss "
          f"{out['gossip_loss']:.4f}, halo forward "
          f"{out['halo_forward']}, halo train loss "
          f"{out['halo_train_loss']:.4f}, dp x halo 2-axis loss "
          f"{out['dp_halo_loss']:.4f}, overlap proof: {rep.summary()} — OK",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m desco_tpu_torch.graft_entry")
    ap.add_argument("--n", type=int, default=4, help="replicas")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' on the CPU)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
