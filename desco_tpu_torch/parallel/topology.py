"""DP x halo composition: a ``data`` x ``graph`` grid of devices — the
port of ``desco_tpu/parallel/topology.py``.

desco_tpu lays out a ("data", "graph") mesh: the ``graph`` axis carries
halo-partitioned single-graph parallelism (one boundary exchange per
layer per query, latency-critical, kept innermost so neighbor ranks sit
on adjacent devices) and the ``data`` axis carries data parallelism (one
gradient reduction per step). Here one controller holds both axes as
lists: replica d is a shard list of parallel/halo.py on row d of the
grid, and the ``data`` reduction is parallel/dp.py's: replica d reads
its own copy of the parameters on its row's first device
(``ReplicaParams``), and the replicas' gradients are summed on the
master device in replica order. Inside a replica the halo path copies
the parameters to each shard's device within the autograd graph, so a
row spread over several devices sums its shards' gradients through
autograd (parallel/halo.py).

desco_tpu's multi-process branch (a hybrid mesh whose ``data`` axis
spans processes, the ``graph`` axis inside each) is the port's process
group (utils/distributed.py): with P ranks and ``n_data`` a multiple of
P, rank r holds the rows [r n_data / P, (r + 1) n_data / P), the whole
graph axis of each row on the rank's card(s); a row another rank holds
is None in the grid and in the placed replicas. Each rank computes its
rows' terms, the terms are gathered in row order and every rank sums
them in row order: the bits of the in-process grid. Where ``n_data`` is
not a multiple of P, desco_tpu falls back to a graph axis across
processes, whose halo exchange between processes is not ported: the
port raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import halo as halo_mod
from ..utils import distributed
from ..utils.cuda_graphs import placed_step_fn
from .dp import (ReplicaParams, apply_reduced, reduce_terms, replica_seed,
                 replica_terms)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """``devices[d][g]``: the device of shard g of replica d (None where
    another rank of the process group holds row d)."""

    devices: tuple

    @property
    def shape(self) -> tuple:
        return (len(self.devices), len(self.devices[0]))


def make_mesh2d(n_data: int, n_graph: int,
                devices: Optional[Sequence] = None) -> Mesh2D:
    """A [n_data][n_graph] grid over ``devices`` (default: the visible
    CUDA devices), the graph axis innermost; the grid cycles over the
    devices as ``halo.shard_devices`` does, so a 2 x 2 grid runs on one
    card (or on the CPU with ``devices=[torch.device("cpu")]``).

    In a process group of P ranks the ``data`` axis spans the ranks, as
    desco_tpu's hybrid mesh spans processes: rank r holds the rows [r
    n_data / P, (r + 1) n_data / P), cycling over ``devices`` (default:
    the rank's card) within the rank. ``n_data`` must be a multiple of
    P."""
    world = distributed.world()
    if world > 1:
        if n_data % world:
            raise ValueError(
                f"a {n_data} x {n_graph} grid over {world} processes: "
                f"n_data must be a multiple of the process count; "
                f"otherwise desco_tpu puts the graph axis across "
                f"processes, whose halo exchange between processes is not "
                f"ported (ROADMAP.md, Queue 1: a halo graph axis across "
                f"processes)")
        devs = (list(devices) if devices is not None
                else [distributed.rank_device("cuda")])
        per, here = n_data // world, distributed.rank()
        rows = []
        for d in range(n_data):
            base = (d - here * per) * n_graph
            rows.append(tuple(
                torch.device(devs[(base + g) % len(devs)])
                if d // per == here else None for g in range(n_graph)))
        return Mesh2D(tuple(rows))
    devs = (list(devices) if devices is not None
            else halo_mod.shard_devices(0, "cuda"))
    n = n_data * n_graph
    flat = [torch.device(devs[i % len(devs)]) for i in range(n)]
    return Mesh2D(tuple(tuple(flat[d * n_graph:(d + 1) * n_graph])
                        for d in range(n_data)))


def harmonized_partitions(specs: list, n_devices: int, **kw) -> list:
    """Partition several graphs to IDENTICAL shapes: partition each, take
    the element-wise max of the padded capacities, and partition again
    with those as ``min_caps`` where a graph's caps fall short.
    ``specs``: one kwargs dict of ``partition_typed_graph`` per replica."""
    parts = [halo_mod.partition_typed_graph(
        n_devices=n_devices, **spec, **kw) for spec in specs]
    caps_each = [halo_mod.partition_caps(p) for p in parts]
    caps = {k: max(c[k] for c in caps_each) for k in caps_each[0]}
    return [
        p if caps_each[i] == caps else halo_mod.partition_typed_graph(
            n_devices=n_devices, min_caps=caps, **specs[i], **kw)
        for i, p in enumerate(parts)
    ]


_ARRAYS = [f.name for f in dataclasses.fields(halo_mod.HaloPartition)
           if f.name not in ("n_graphs", "n_types")]


def stack_partitions(parts: list) -> halo_mod.HaloPartition:
    """n_data harmonized partitions (leading axis n_graph each) as one with
    a leading n_data * n_graph axis: row d * n_graph + g is shard g of
    replica d."""
    stacked = {name: (None if getattr(parts[0], name) is None
                      else np.concatenate([np.asarray(getattr(p, name))
                                           for p in parts], axis=0))
               for name in _ARRAYS}
    return halo_mod.HaloPartition(n_graphs=parts[0].n_graphs,
                                  n_types=parts[0].n_types, **stacked)


def place_replicas(stacked: halo_mod.HaloPartition,
                   mesh: Mesh2D) -> List[Optional[List[halo_mod.HaloShard]]]:
    """A stacked partition on the grid: per replica d, the shard list of
    its rows (``halo.place_shards`` on row d's devices), None where
    another rank holds row d."""
    n_data, n_graph = mesh.shape
    if stacked.n_devices != n_data * n_graph:
        raise ValueError(f"{stacked.n_devices} shards for a "
                         f"{n_data} x {n_graph} grid")
    out = []
    for d in range(n_data):
        if mesh.devices[d][0] is None:
            out.append(None)
            continue
        rows = slice(d * n_graph, (d + 1) * n_graph)
        part = dataclasses.replace(stacked, **{
            name: getattr(stacked, name)[rows] for name in _ARRAYS
            if getattr(stacked, name) is not None})
        out.append(halo_mod.place_shards(part, mesh.devices[d]))
    return out


def _local_rows(replicas) -> list:
    """The rows this process holds."""
    return [d for d, shards in enumerate(replicas) if shards is not None]


def _row_devices(replicas) -> list:
    """The device of each local replica's parameters: its first shard's."""
    return [replicas[d][0].device for d in _local_rows(replicas)]


def _local_halo_terms(params, replicas, query_embs, dropout, copies,
                      generators) -> torch.Tensor:
    """``dp.replica_terms`` of the rows this process holds: each row's
    ``halo_gossip_loss`` on its own parameter copy."""
    home = next(params.parameters()).device
    local = _local_rows(replicas)
    if (len(local) < len(replicas)) != (distributed.world() > 1):
        raise ValueError("in a process group the grid's rows span the "
                         "ranks (make_mesh2d), and only there")
    reps = (copies or ReplicaParams()).sync(params, _row_devices(replicas))
    train = dropout > 0.0

    def losses(j):
        d = local[j]
        return halo_mod.halo_gossip_loss(
            reps[j], replicas[d], query_embs, dropout, train=train,
            generators=generators[d] if train else None)

    return replica_terms(losses, reps, home)


def dp_halo_gossip_loss_and_grads(params, replicas, query_embs: torch.Tensor,
                                  dropout: float = 0.0,
                                  copies: Optional[ReplicaParams] = None,
                                  generators: Optional[list] = None):
    """(loss, flat gradient) on the master device: the sum over replicas of
    each replica's ``halo_gossip_loss`` (desco_tpu's ``"sum"`` weighting)
    on its own parameter copy (``copies`` keeps them between steps),
    each replica's gradient taken alone and summed in replica order;
    across ranks each rank computes its rows and the rows' terms are
    gathered first. Dropout above 0 draws replica d's masks from
    ``generators[d]``, one generator per shard."""
    terms = _local_halo_terms(params, replicas, query_embs, dropout, copies,
                              generators)
    return reduce_terms(distributed.gather_in_rank_order(terms))


def dp_halo_gossip_step_fn(opt, dropout: float = 0.0, graphed: bool = False):
    """The composed gossip train step: ``step(params, replicas, query_embs,
    lr, seed=0) -> (loss, ok)``, ``replicas`` from ``place_replicas``;
    ``opt`` the port's Adam over ``params`` with ``train_step``'s
    finite-loss guard. Dropout masks come from generators per (replica,
    shard), made once and reseeded at every call. The step's parts are
    ``DPStep``'s: the local rows' terms, their exchange (the gather
    across ranks, whose first call checks that every rank holds the same
    parameters) and the ordered sum with Adam. ``graphed``: the local
    part and the sum are captured at the first call and replayed
    (utils/cuda_graphs.placed_step_fn), the exchange between them."""
    copies = ReplicaParams()
    gens: dict = {}
    checked = []

    def reseed(replicas, seed):
        if dropout <= 0.0:
            return []
        out = []
        for d in _local_rows(replicas):
            g = gens.setdefault(d, halo_mod.ShardGenerators())
            out += g.seed(replicas[d], replica_seed(seed, d))
        return out

    def local(params, replicas, query_embs):
        return _local_halo_terms(
            params, replicas, query_embs, dropout, copies,
            {d: g.gens for d, g in gens.items()} if dropout > 0.0 else None)

    def exchange(terms):
        if not checked:
            distributed.check_replicated(opt.flat, "parameters")
            checked.append(True)
        return distributed.gather_in_rank_order(terms)

    def finish(terms, lr):
        loss, flat = reduce_terms(terms)
        return apply_reduced(opt, loss, flat, lr)

    return placed_step_fn(local, reseed, opt, graphed=graphed,
                          exchange=exchange, finish=finish)


def dp_halo_shmp_forward(cfg):
    """The composed SHMP core forward: ``fwd(params, replicas)`` -> per
    replica the per-shard embeddings of ``halo.halo_shmp_core`` over its
    own graph and parameter copy (the exchanges stay within a replica's
    row), None for a row another rank holds."""
    copies = ReplicaParams()

    def fwd(params, replicas):
        reps = iter(copies.sync(params, _row_devices(replicas)))
        return [None if shards is None
                else halo_mod.halo_shmp_core(next(reps), cfg, shards)
                for shards in replicas]

    return fwd
