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
autograd (parallel/halo.py). desco_tpu's multi-process branch (a hybrid
mesh over processes) has no counterpart in one process (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import halo as halo_mod
from ..utils.cuda_graphs import placed_step_fn
from .dp import (ReplicaParams, apply_reduced, replica_loss_and_grads,
                 replica_seed)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """``devices[d][g]``: the device of shard g of replica d."""

    devices: tuple

    @property
    def shape(self) -> tuple:
        return (len(self.devices), len(self.devices[0]))


def make_mesh2d(n_data: int, n_graph: int,
                devices: Optional[Sequence] = None) -> Mesh2D:
    """A [n_data][n_graph] grid over ``devices`` (default: the visible
    CUDA devices), the graph axis innermost; the grid cycles over the
    devices as ``halo.shard_devices`` does, so a 2 x 2 grid runs on one
    card (or on the CPU with ``devices=[torch.device("cpu")]``)."""
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
                   mesh: Mesh2D) -> List[List[halo_mod.HaloShard]]:
    """A stacked partition on the grid: per replica d, the shard list of
    its rows (``halo.place_shards`` on row d's devices)."""
    n_data, n_graph = mesh.shape
    if stacked.n_devices != n_data * n_graph:
        raise ValueError(f"{stacked.n_devices} shards for a "
                         f"{n_data} x {n_graph} grid")
    out = []
    for d in range(n_data):
        rows = slice(d * n_graph, (d + 1) * n_graph)
        part = dataclasses.replace(stacked, **{
            name: getattr(stacked, name)[rows] for name in _ARRAYS
            if getattr(stacked, name) is not None})
        out.append(halo_mod.place_shards(part, mesh.devices[d]))
    return out


def _row_devices(replicas) -> list:
    """The device of each replica's parameters: its first shard's."""
    return [shards[0].device for shards in replicas]


def dp_halo_gossip_loss_and_grads(params, replicas, query_embs: torch.Tensor,
                                  dropout: float = 0.0,
                                  copies: Optional[ReplicaParams] = None,
                                  generators: Optional[list] = None):
    """(loss, flat gradient) on the master device: the sum over replicas of
    each replica's ``halo_gossip_loss`` (desco_tpu's ``"sum"`` weighting)
    on its own parameter copy (``copies`` keeps them between steps),
    each replica's gradient taken alone and summed in replica order.
    Dropout above 0 draws replica d's masks from ``generators[d]``, one
    generator per shard."""
    home = next(params.parameters()).device
    reps = (copies or ReplicaParams()).sync(params, _row_devices(replicas))
    train = dropout > 0.0

    def losses(d):
        return halo_mod.halo_gossip_loss(
            reps[d], replicas[d], query_embs, dropout, train=train,
            generators=generators[d] if train else None)

    return replica_loss_and_grads(losses, reps, home)


def dp_halo_gossip_step_fn(opt, dropout: float = 0.0, graphed: bool = False):
    """The composed gossip train step: ``step(params, replicas, query_embs,
    lr, seed=0) -> (loss, ok)``, ``replicas`` from ``place_replicas``;
    ``opt`` the port's Adam over ``params`` with ``train_step``'s
    finite-loss guard. Dropout masks come from generators per (replica,
    shard), made once and reseeded at every call. ``graphed``: captured
    at the first call and replayed (``halo.halo_gossip_step_fn``)."""
    copies = ReplicaParams()
    gens: List[halo_mod.ShardGenerators] = []

    def reseed(replicas, seed):
        if dropout <= 0.0:
            return []
        while len(gens) < len(replicas):
            gens.append(halo_mod.ShardGenerators())
        return [g for d, shards in enumerate(replicas)
                for g in gens[d].seed(shards, replica_seed(seed, d))]

    def body(params, replicas, query_embs, lr):
        loss, flat = dp_halo_gossip_loss_and_grads(
            params, replicas, query_embs, dropout, copies=copies,
            generators=[g.gens for g in gens] if dropout > 0.0 else None)
        return apply_reduced(opt, loss, flat, lr)

    return placed_step_fn(body, reseed, opt, graphed=graphed)


def dp_halo_shmp_forward(cfg):
    """The composed SHMP core forward: ``fwd(params, replicas)`` -> per
    replica the per-shard embeddings of ``halo.halo_shmp_core`` over its
    own graph and parameter copy (the exchanges stay within a replica's
    row)."""
    copies = ReplicaParams()

    def fwd(params, replicas):
        reps = copies.sync(params, _row_devices(replicas))
        return [halo_mod.halo_shmp_core(p, cfg, shards)
                for p, shards in zip(reps, replicas)]

    return fwd
