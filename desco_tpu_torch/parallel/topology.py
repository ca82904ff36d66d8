"""DP x halo composition: a ``data`` x ``graph`` grid of devices — the
port of ``desco_tpu/parallel/topology.py``.

desco_tpu lays out a ("data", "graph") mesh: the ``graph`` axis carries
halo-partitioned single-graph parallelism (one boundary exchange per
layer per query, latency-critical, kept innermost so neighbor ranks sit
on adjacent devices) and the ``data`` axis carries data parallelism (one
gradient reduction per step). Here a process holds both axes as lists:
replica d is a shard list of parallel/halo.py on row d of the grid. The
reduction is explicit, per (replica, shard) slot: each slot's gradient
is that of its own leaves of the parameters (``halo.slot_terms``), one
row [flat gradient, term] per slot; the rows are added per replica in shard
order, then over the replicas in replica order, on the master device.

desco_tpu's multi-process branches are the port's process group
(utils/distributed.py). Its grid is the flat (n_data * n_graph) list of
every process's devices, process-major: with P ranks, slot i = d *
n_graph + g lies on rank i // (n_data * n_graph / P). Where ``n_data``
is a multiple of P that is desco_tpu's hybrid mesh (the ``data`` axis
over the processes, each row whole on one rank); otherwise it is its
plain fallback grid, and a row's graph axis may cross ranks: its halo
exchanges then go between the ranks (parallel/halo.py). A slot another
rank holds is None in the grid and in the placed replicas, a row of
which this rank holds no slot is None. Each rank computes the rows of
its own slots, the rows are gathered in rank order (which is slot
order) and every rank sums them as one process would: the bits of the
in-process grid.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import halo as halo_mod
from ..utils import distributed
from ..utils.cuda_graphs import GraphedStep, clone_outputs, placed_step_fn
from .dp import apply_reduced, replica_seed


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """``devices[d][g]``: the device of shard g of replica d (None where
    another rank of the process group holds that slot); ``ranks[d][g]``:
    the rank that holds it."""

    devices: tuple
    ranks: tuple

    @property
    def shape(self) -> tuple:
        return (len(self.devices), len(self.devices[0]))


def make_mesh2d(n_data: int, n_graph: int,
                devices: Optional[Sequence] = None) -> Mesh2D:
    """A [n_data][n_graph] grid over ``devices`` (default: the visible
    CUDA devices), the graph axis innermost; the grid cycles over the
    devices as ``halo.shard_devices`` does, so a 2 x 2 grid runs on one
    card (or on the CPU with ``devices=[torch.device("cpu")]``).

    In a process group of P ranks the grid is desco_tpu's flat reshape of
    every process's devices: slot i = d * n_graph + g lies on rank i //
    (n_data * n_graph / P), and each rank cycles its slots over
    ``devices`` (default: the rank's card). Where n_data is a multiple of
    P each rank holds whole rows (desco_tpu's hybrid mesh); otherwise
    rows cross ranks (its fallback grid), and every rank makes the
    process group of each such row's ranks here: every rank calls it
    alike. n_data * n_graph must be a multiple of P."""
    world, here = distributed.world(), distributed.rank()
    n = n_data * n_graph
    if n % world:
        raise ValueError(
            f"a {n_data} x {n_graph} grid over {world} processes: every "
            f"process holds as many slots, so n_data * n_graph must be a "
            f"multiple of the process count")
    if world > 1:
        devs = (list(devices) if devices is not None
                else [distributed.rank_device("cuda")])
    else:
        devs = (list(devices) if devices is not None
                else halo_mod.shard_devices(0, "cuda"))
    per = n // world
    ranks = [i // per for i in range(n)]
    for d in range(n_data):  # every rank makes the rows' groups, in order
        members = sorted(set(ranks[d * n_graph:(d + 1) * n_graph]))
        if len(members) > 1:
            distributed.group_of(members, make=True)
    flat = [torch.device(devs[(i - here * per) % len(devs)])
            if ranks[i] == here else None for i in range(n)]
    return Mesh2D(*(tuple(tuple(a[d * n_graph:(d + 1) * n_graph])
                          for d in range(n_data)) for a in (flat, ranks)))


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
                   mesh: Mesh2D) -> List[Optional[list]]:
    """A stacked partition on the grid: per replica d, the shard list of
    row d (``halo.place_shards`` on the row's devices and ranks, None for
    a slot another rank holds), None for a row of which this rank holds
    no slot. Every rank of the group calls it with the same grid."""
    n_data, n_graph = mesh.shape
    if stacked.n_devices != n_data * n_graph:
        raise ValueError(f"{stacked.n_devices} shards for a "
                         f"{n_data} x {n_graph} grid")
    out = []
    for d in range(n_data):
        if all(dev is None for dev in mesh.devices[d]):
            out.append(None)
            continue
        rows = slice(d * n_graph, (d + 1) * n_graph)
        part = dataclasses.replace(stacked, **{
            name: getattr(stacked, name)[rows] for name in _ARRAYS
            if getattr(stacked, name) is not None})
        out.append(halo_mod.place_shards(part, mesh.devices[d],
                                         ranks=mesh.ranks[d]))
    return out


def _local_halo_terms(params, replicas, query_embs, dropout,
                      generators) -> torch.Tensor:
    """[L, n + 1]: ``halo.slot_terms`` of every slot this process holds,
    row by row, in slot order (the rows' collectives in the same order on
    every rank), written into one buffer."""
    held = [(d, shards) for d, shards in enumerate(replicas)
            if shards is not None]
    counts = [len(halo_mod.local_shards(shards)) for _, shards in held]
    n = sum(p.numel() for p in params.parameters())
    rows = torch.zeros((sum(counts), n + 1),
                       device=next(params.parameters()).device)
    off = 0
    for (d, shards), k in zip(held, counts):
        halo_mod.slot_terms(params, shards, query_embs, dropout,
                            generators[d] if dropout > 0.0 else None,
                            out=rows[off:off + k])
        off += k
    return rows


def reduce_grid_terms(terms: torch.Tensor, n_graph: int):
    """The explicit ``psum`` over both axes: every slot's row of
    ``halo.slot_terms`` [n_data * n_graph, n + 1], added per replica in
    shard order, then over the replicas in replica order. Returns (the
    objective, the flat gradient)."""
    total = None
    for d in range(0, terms.shape[0], n_graph):
        row = terms[d]
        for r in terms[d + 1:d + n_graph]:
            row = row + r
        total = row if total is None else total + row
    return total[-1], total[:-1]


def _n_graph(replicas) -> int:
    return len(next(r for r in replicas if r is not None))


def dp_halo_gossip_loss_and_grads(params, replicas, query_embs: torch.Tensor,
                                  dropout: float = 0.0,
                                  generators: Optional[dict] = None):
    """(loss, flat gradient) on the master device: the sum over replicas of
    each replica's ``halo_gossip_loss`` (desco_tpu's ``"sum"`` weighting),
    each (replica, shard) slot's gradient taken alone on its own
    parameter leaves (``halo.slot_terms``), gathered across ranks and added
    as ``reduce_grid_terms`` adds them. Dropout above 0 draws replica d's
    masks from ``generators[d]``, one generator per local shard."""
    terms = _local_halo_terms(params, replicas, query_embs, dropout,
                              generators)
    return reduce_grid_terms(distributed.gather_in_rank_order(terms),
                             _n_graph(replicas))


def dp_halo_gossip_step_fn(opt, dropout: float = 0.0, graphed: bool = False):
    """The composed gossip train step: ``step(params, replicas, query_embs,
    lr, seed=0) -> (loss, ok)``, ``replicas`` from ``place_replicas``;
    ``opt`` the port's Adam over ``params`` with ``train_step``'s
    finite-loss guard. Dropout masks come from generators per (replica,
    shard), made once and reseeded at every call. The step's parts: the
    local slots' rows (``halo.slot_terms``), their exchange (the gather
    across ranks) and ``reduce_grid_terms`` with Adam; before them, once,
    the check that every rank holds the same parameters and each row's
    direction degrees. ``graphed``: the step is captured at the first
    call and replayed (utils/cuda_graphs.placed_step_fn): one CUDA graph
    in one process, a chain of graphs split at the rows' exchanges and
    the gather across ranks."""
    gens: dict = {}
    grid: dict = {}

    def reseed(replicas, seed):
        if dropout <= 0.0:
            return []
        out = []
        for d, shards in enumerate(replicas):
            if shards is not None:
                g = gens.setdefault(d, halo_mod.ShardGenerators())
                out += g.seed(shards, replica_seed(seed, d))
        return out

    def prepare(replicas):
        grid["n_graph"] = _n_graph(replicas)
        if not grid.get("checked"):
            distributed.check_replicated(opt.flat, "parameters")
            grid["checked"] = True
        for shards in replicas:
            if shards is not None:
                halo_mod.halo_direction_degrees(shards)

    def local(params, replicas, query_embs):
        return _local_halo_terms(
            params, replicas, query_embs, dropout,
            {d: g.gens for d, g in gens.items()})

    def finish(terms, lr):
        loss, flat = reduce_grid_terms(terms, grid["n_graph"])
        return apply_reduced(opt, loss, flat, lr)

    return placed_step_fn(local, reseed, opt, graphed=graphed,
                          exchange=distributed.gather_in_rank_order,
                          finish=finish, prepare=prepare)


def dp_halo_shmp_forward(cfg, graphed: bool = True):
    """The composed SHMP core forward: ``fwd(params, replicas)`` -> per
    replica the per-shard embeddings of ``halo.halo_shmp_core`` over its
    own graph (the exchanges stay within a replica's row, across ranks
    where the row crosses them), None for a slot another rank holds and
    for a row of which this rank holds no slot.

    ``graphed`` (desco_tpu jits it): the forward is captured under
    inference mode at the first call, for that call's ``params`` and
    ``replicas``, which later calls must pass again, and every call
    returns copies of its outputs (utils/cuda_graphs.GraphedStep with
    ``inference``): one CUDA graph in one process, a chain of graphs
    split at the exchanges where a row crosses ranks; static buffers
    without a capture on the CPU. ``graphed=False``: eager."""

    def fwd(params, replicas):
        out = []
        for shards in replicas:
            if shards is None:
                out.append(None)
                continue
            embs = iter(halo_mod.halo_shmp_core(params, cfg, shards))
            out.append([None if sh is None else next(embs)
                        for sh in shards])
        return out

    if not graphed:
        return fwd
    held: dict = {}

    def compiled(params, replicas):
        if held and (params is not held["params"]
                     or replicas is not held["replicas"]):
            raise ValueError("a graphed forward replays over the parameters "
                             "and data of its first call")
        if not held:
            dev = next(halo_mod.local_shards(shards)[0].device
                       for shards in replicas if shards is not None)
            held.update(params=params, replicas=replicas, step=GraphedStep(
                lambda _: fwd(params, replicas), (),
                capture=dev.type == "cuda", inference=True, device=dev))
        return clone_outputs(held["step"](()))

    compiled.held = held
    return compiled
