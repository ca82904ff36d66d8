"""Data parallelism over a list of replicas — the port of
``desco_tpu/parallel/dp.py``.

desco_tpu runs each device's batch under ``shard_map`` over a ``data``
mesh axis and lets ``psum`` reduce the gradients; on a multi-host slice
that axis spans processes (desco_tpu/parallel/topology.py:55-64). Here a
process holds its replicas as a list (the design of parallel/halo.py):
in one process replica d sits on ``mesh.devices[d]``, the devices
cycling over the visible CUDA devices (``shard_devices``), so D replicas
run on one card, and on the CPU all of them share it. In a
``torch.distributed`` group of P ranks (utils/distributed.py) rank r
holds the replicas [r D / P, (r + 1) D / P) on its own card, the data
axis outermost as desco_tpu's hybrid mesh lays it out, and every rank
holds the whole host dataset. ``psum`` over ``data`` is an explicit
reduction:

  1. each replica this process holds computes its objective term and
     its gradient with ``torch.autograd.grad`` on its own batch, one row
     [flat gradient, term] each (``local_loss_terms``);
  2. across ranks the rows are gathered in replica order
     (``gather_in_rank_order``; never ``all_reduce``, whose order is the
     backend's), and every rank sums all D rows in replica order on its
     master device, so every rank holds the bits one process holding the
     D replicas would;
  3. every rank runs the same Adam step on its master parameters, which
     therefore stay bit-identical across ranks (a first-step digest
     checks it, ``DPStep``);
  4. a replica on another device gets the master parameters copied in
     before its next forward (``ReplicaParams``); replicas on the
     master's device use the master module itself. No gradient crosses
     devices through autograd, whose order of accumulation is not fixed.

Where a process's replicas share one card, in one process as across
ranks, the training loop (train/loop.Steps) captures the step
(``DPStep(graphed=True)``): one CUDA graph in one process; across ranks
two, the process's replicas' forwards and gradients and the sum with
Adam, split at the gather, which runs between their replays (no graph
holds a collective, utils/cuda_graphs.GraphedStep). The replica
generators are made once per run and reseeded
(``reseed_replica_generators``), so the graphs keep reading them. A mesh over several cards in one process trains with the eager
step.

Gradient semantics are desco_tpu's:
  * ``"graphs"`` (neighborhood, a mean loss): the objective is
    sum_d loss_d * w_d / max(sum_d w_d, 1), w_d the replica's valid
    graph count (summed on every rank from every replica's batch), so
    all-masked pad batches weigh exactly 0;
  * ``"sum"`` (gossip, a sum loss): the objective is sum_d loss_d.

Prediction runs batch i on replica i % D, pads the batch list to a
multiple of D with all-masked copies of batch 0 (which run too, as in
desco_tpu), gathers every replica's predictions across ranks and
stitches the valid rows back in batch order with one read-back: every
rank returns the array the single-device predict functions of
train/loop.py return, bit for bit. Serving and the CLI always predict
here, on a one-replica mesh when there is no data parallelism, and
replay each replica's compiled forward (desco_tpu jits its DP predicts).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..batch.packed import PackedGraphs, stack_batches
from ..utils import distributed, trace
from ..utils.cuda_graphs import ForwardCache, GraphedStep
from ..utils.device import resolve_device
from .halo import shard_devices


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """desco_tpu's ``data`` mesh: the device of every replica, None for a
    replica another rank of the process group holds. ``ranks[d]``: the
    rank holding replica d (empty: all of them in this process)."""

    devices: Tuple[Optional[torch.device], ...]
    ranks: Tuple[int, ...] = ()

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def world(self) -> int:
        return max(self.ranks) + 1 if self.ranks else 1

    @property
    def local(self) -> Tuple[int, ...]:
        """The replicas this process holds, in replica order."""
        return tuple(d for d, dev in enumerate(self.devices)
                     if dev is not None)


def make_mesh(n_devices: int = 0, device=None) -> DataMesh:
    """``n_devices`` replicas (0: one per visible CUDA device, one on the
    CPU) cycling over the visible CUDA devices, or all on the CPU for a
    CPU ``device`` (None means CUDA and raises without a GPU). The count
    is taken as given: 4 replicas on one card share it. One replica on a
    numbered CUDA device sits on that device.

    In a process group of P ranks (utils/distributed.py) ``n_devices``
    counts the replicas of every rank, as desco_tpu's ``len(jax.devices())``
    counts every process's devices (0: one per rank), and must be a
    multiple of P. Rank r holds the replicas [r D / P, (r + 1) D / P),
    contiguous with the data axis outermost as desco_tpu's hybrid mesh
    lays them out, all on the rank's device (``rank_device``)."""
    device = resolve_device(device)
    world = distributed.world()
    if world == 1:
        if n_devices == 1 and device.index is not None:
            return DataMesh((device,))
        return DataMesh(tuple(shard_devices(n_devices, device)))
    n = n_devices if n_devices > 0 else world
    if n % world:
        raise ValueError(f"{n} data-parallel replicas do not split over "
                         f"{world} processes: the count must be a multiple "
                         f"of the process count")
    per, here = n // world, distributed.rank()
    dev = (device if device.index is not None
           else distributed.rank_device(device))
    ranks = tuple(d // per for d in range(n))
    return DataMesh(tuple(dev if r == here else None for r in ranks), ranks)


@dataclasses.dataclass
class RemoteBatch:
    """The stand-in of a batch another rank holds: its graph mask alone,
    on this rank's device, which the ``"graphs"`` weighting reads (every
    rank weighs the step by every replica's valid graphs)."""

    graph_mask: torch.Tensor


def pad_batches_to_multiple(batches: list, d: int) -> list:
    """Append all-masked copies of batch 0 (``node_mask`` and
    ``graph_mask`` zero) until ``len % d == 0``; they weigh 0 in the DP
    gradient."""
    if len(batches) % d == 0:
        return batches
    pad = batches[0]
    empty = dataclasses.replace(
        pad, node_mask=np.zeros_like(pad.node_mask),
        graph_mask=np.zeros_like(pad.graph_mask))
    out = list(batches)
    while len(out) % d:
        out.append(empty)
    return out


def reshape_for_dp(batches: list, d: int) -> List[list]:
    """Batches -> groups of ``d`` (one per step; the count must divide)."""
    if len(batches) % d:
        raise ValueError(f"{len(batches)} batches do not split into "
                         f"groups of {d}")
    return [batches[i:i + d] for i in range(0, len(batches), d)]


def place_batches(batches: Sequence[PackedGraphs], mesh: DataMesh,
                  training: bool = False) -> list:
    """Batch i on replica i % D's device, each device's batches moved in
    one stacked copy (``training`` keeps labels and the backward
    permutation). A batch of a replica another rank holds becomes a
    ``RemoteBatch``: every rank holds the whole host dataset, as every
    desco_tpu process holds the global arrays, and places its own."""
    devs = [mesh.devices[i % mesh.size] for i in range(len(batches))]
    out: list = [None] * len(batches)
    for dev in dict.fromkeys(d for d in devs if d is not None):
        idx = [i for i, d in enumerate(devs) if d == dev]
        stacked = stack_batches([batches[i] for i in idx]).to(
            dev, training=training)
        for j, i in enumerate(idx):
            out[i] = stacked[j]
    remote = [i for i, d in enumerate(devs) if d is None]
    if remote:
        here = mesh.devices[mesh.local[0]]
        masks = torch.from_numpy(np.stack(
            [np.asarray(batches[i].graph_mask) for i in remote]))
        trace.add("h2d_bytes", masks.nbytes)
        masks = masks.to(here)
        for j, i in enumerate(remote):
            out[i] = RemoteBatch(masks[j])
    return out


def replica_seed(seed: int, d: int) -> int:
    """The dropout seed of replica d: desco_tpu folds ``axis_index('data')``
    into its key, and the two match in distribution only."""
    return (int(seed) * 1_000_003 + 7919 * (d + 1)) % (2 ** 63 - 1)


def replica_generators(mesh: DataMesh, seed: int) -> list:
    """One dropout generator per replica, on its device, seeded with
    ``replica_seed(seed, d)``; None for a replica another rank holds."""
    return reseed_replica_generators(
        [None if dev is None else torch.Generator(device=dev)
         for dev in mesh.devices], seed)


def reseed_replica_generators(generators: list, seed: int) -> list:
    """Seed replica d's generator with ``replica_seed(seed, d)`` in place:
    the state ``replica_generators(mesh, seed)`` starts from, on the same
    objects (a captured step keeps them registered)."""
    for d, gen in enumerate(generators):
        if gen is not None:
            gen.manual_seed(replica_seed(seed, d))
    return generators


class ReplicaParams:
    """The parameter module each replica reads: the master itself on the
    master's device, elsewhere a copy per device that ``sync`` refreshes
    from the master."""

    def __init__(self):
        self.copies: dict = {}

    def sync(self, params, devices: Sequence[torch.device]) -> list:
        """One module per replica, replica d's on ``devices[d]``."""
        home = next(params.parameters()).device
        out = []
        for dev in devices:
            if dev == home:
                out.append(params)
                continue
            rep = self.copies.get(dev)
            if rep is None:
                rep = self.copies[dev] = copy.deepcopy(params).to(dev)
            else:
                with torch.no_grad():
                    for r, m in zip(rep.parameters(), params.parameters()):
                        r.copy_(m)
            out.append(rep)
        return out


def _flat_grad(params, objective: torch.Tensor) -> torch.Tensor:
    """d objective / d params as one flat vector in parameter order (zero
    where a parameter gets no gradient)."""
    ps = list(params.parameters())
    grads = torch.autograd.grad(objective, ps, allow_unused=True)
    return torch.cat([(g if g is not None else torch.zeros_like(p))
                      .reshape(-1) for g, p in zip(grads, ps)])


def replica_terms(losses: Callable[[int], torch.Tensor], replicas: list,
                  home: torch.device) -> torch.Tensor:
    """[L, n + 1] on ``home``: for the j-th of the L replicas this process
    holds, ``losses(j)`` is its scalar objective term; row j is the term's
    gradient, taken alone, as one flat vector in parameter order, then
    the term itself."""
    rows = []
    for j, params in enumerate(replicas):
        obj = losses(j)
        rows.append(torch.cat([_flat_grad(params, obj).to(home),
                               obj.detach().to(home).reshape(1)]))
    return torch.stack(rows)


def reduce_terms(terms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The explicit ``psum``: every replica's row of ``replica_terms``, in
    replica order, summed one row after the other. Returns (the objective,
    the flat gradient)."""
    total = terms[0]
    for row in terms[1:]:
        total = total + row
    return total[-1], total[:-1]


def local_loss_terms(loss_fn: Callable, params, group: Sequence,
                     mesh: DataMesh, weight_kind: str = "graphs",
                     generators: Optional[list] = None,
                     replicas: Optional[ReplicaParams] = None
                     ) -> torch.Tensor:
    """``replica_terms`` of the replicas this process holds, on the
    master device. ``loss_fn(params, batch, generator) -> scalar``;
    ``group[d]`` lies on ``mesh.devices[d]`` (a ``RemoteBatch`` where
    another rank holds replica d)."""
    if weight_kind not in ("graphs", "sum"):
        raise ValueError(f"weight_kind must be 'graphs' or 'sum', "
                         f"got {weight_kind!r}")
    if len(group) != mesh.size:
        raise ValueError(f"a DP step takes {mesh.size} batches, got "
                         f"{len(group)}")
    home = next(params.parameters()).device
    local = mesh.local
    reps = (replicas or ReplicaParams()).sync(
        params, [mesh.devices[d] for d in local])
    gens = generators or [None] * mesh.size
    if weight_kind == "graphs":
        # every replica's valid graphs, in replica order, on every rank
        ws = [b.graph_mask.sum() for b in group]
        wsum = ws[0].to(home)
        for w in ws[1:]:
            wsum = wsum + w.to(home)
        wsum = torch.clamp(wsum, min=1.0)

        def losses(j):
            d = local[j]
            return (loss_fn(reps[j], group[d], gens[d]) * ws[d]
                    / wsum.to(ws[d].device))
    else:
        def losses(j):
            d = local[j]
            return loss_fn(reps[j], group[d], gens[d])
    return replica_terms(losses, reps, home)


def dp_loss_and_grads(loss_fn: Callable, params, group: Sequence,
                      mesh: DataMesh, weight_kind: str = "graphs",
                      generators: Optional[list] = None,
                      replicas: Optional[ReplicaParams] = None):
    """(global loss, reduced flat gradient) of one DP step on the master
    device: ``local_loss_terms``, gathered from every rank in replica
    order (``gather_in_rank_order``, no ``all_reduce``), then
    ``reduce_terms``; the same bits on every rank and as in one process."""
    return reduce_terms(distributed.gather_in_rank_order(local_loss_terms(
        loss_fn, params, group, mesh, weight_kind, generators, replicas)))


def apply_reduced(opt, loss: torch.Tensor, flat: torch.Tensor, lr):
    """One Adam step (train/loop.Adam) on a reduced gradient with
    ``train_step``'s non-finite guard on the global loss, kept on the
    device. Returns (loss, ok)."""
    opt.grad.copy_(flat)
    ok = torch.isfinite(loss)
    opt.step(lr, ok)
    return loss, ok


class DPStep:
    """A DP train step: ``step(params, group, lr, generators=None) ->
    (loss, ok)``, ``params`` the master module ``opt`` (train/loop.Adam)
    was made from, ``group`` one batch per replica (``place_batches``),
    ``generators`` one per replica (``replica_generators``). The reduced
    gradient lands in ``opt.grad`` (``apply_reduced``).

    Its parts: ``local`` (this process's replicas' terms), ``exchange``
    (every replica's terms: across ranks the gather) and ``finish`` (the
    ordered sum and Adam); before the first call's, the check that every
    rank holds the same parameters (it raises if not). ``graphed``: the
    step is captured at the first call, for that call's ``params`` and
    ``generators`` (utils/cuda_graphs.GraphedStep: one CUDA graph in one
    process, two split at the gather across ranks; static buffers
    without a capture on the CPU); it needs this process's replicas on
    one device. ``prepare`` makes it ahead of the first call."""

    def __init__(self, loss_fn: Callable, opt, mesh: DataMesh,
                 weight_kind: str = "graphs", graphed: bool = False):
        devices = {mesh.devices[d] for d in mesh.local}
        if graphed and len(devices) > 1:
            raise ValueError(f"a graphed DP step records one device; the "
                             f"replicas lie on {sorted(map(str, devices))}")
        self.loss_fn, self.opt, self.mesh = loss_fn, opt, mesh
        self.weight_kind, self.graphed = weight_kind, graphed
        self.replicas = ReplicaParams()
        self.checked = False
        self.held = None

    def local(self, params, group, generators=None) -> torch.Tensor:
        return local_loss_terms(self.loss_fn, params, group, self.mesh,
                                self.weight_kind, generators, self.replicas)

    def exchange(self, terms: torch.Tensor) -> torch.Tensor:
        return distributed.gather_in_rank_order(terms)

    def finish(self, terms: torch.Tensor, lr):
        loss, flat = reduce_terms(terms)
        return apply_reduced(self.opt, loss, flat, lr)

    def check(self) -> None:
        """Once: every rank holds the same parameters."""
        if not self.checked:
            distributed.check_replicated(self.opt.flat, "parameters")
            self.checked = True

    def prepare(self, params, group, generators=None) -> None:
        """Make the graphed step (``graphed``) for ``params`` and
        ``generators``, which every call must then pass, on the static
        buffers of ``group``; the first call makes it where no one did."""
        self.check()
        flat = self.opt.flat

        def step(b):
            return self.finish(self.exchange(
                self.local(params, b[0], generators)), b[1])

        self.held = (params, generators, GraphedStep(
            step, (group, flat.new_zeros(())),
            capture=flat.device.type == "cuda",
            state=self.opt.state_tensors(),
            generators=[g for g in generators or () if g is not None]))

    def __call__(self, params, group, lr, generators=None):
        if not self.graphed:
            self.check()
            return self.finish(self.exchange(
                self.local(params, group, generators)), lr)
        if self.held is None:
            self.prepare(params, group, generators)
        elif params is not self.held[0] or generators is not self.held[1]:
            raise ValueError("a graphed DP step replays over the parameters "
                             "and generators of its first call")
        if not isinstance(lr, torch.Tensor):
            lr = torch.full((), float(lr), device=self.opt.flat.device)
        loss, ok = self.held[2]((group, lr))
        return loss.clone(), ok.clone()


# ------------------------------------------------------------ prediction
def stage_batches_for_dp(batches: List[PackedGraphs],
                         mesh: DataMesh) -> List[PackedGraphs]:
    """A request's batches padded to a multiple of D and placed on their
    replicas: the ``staged`` argument of the DP predict functions, which
    the members of an ensemble share."""
    return place_batches(pad_batches_to_multiple(list(batches), mesh.size),
                         mesh)


# the spans of each predict's stages: the batches' copy to the card, each
# compiled forward's call, stacking and reading the predictions back
STAGE1_SPANS = ("stage1.stage", "stage1.replay", "stage1.readback")
GOSSIP_SPANS = ("gossip.stage", "gossip.replay", "gossip.readback")


def _dp_predict(make_forward: Callable, params, query_embs: torch.Tensor,
                batches: List[PackedGraphs], mesh: DataMesh,
                mask_field: str, staged, graphed: bool, cache, spans):
    from ..train.loop import _valid_rows

    home = query_embs.device
    if graphed and cache is None:
        cache = ForwardCache()
    with torch.inference_mode():
        if staged is None:
            with trace.span(spans[0]):
                staged = stage_batches_for_dp(batches, mesh)
        # a cache keeps its replicas' copies: its graphs read their storage
        if cache is not None and cache.replicas is None:
            cache.replicas = ReplicaParams()
        local = mesh.local
        devs = [mesh.devices[d] for d in local]
        reps = (cache.replicas if cache is not None
                else ReplicaParams()).sync(params, devs)
        forwards = [make_forward(p, graphed, cache) for p in reps]
        embs = {dev: query_embs.to(dev) for dev in devs}
        # replica d runs the batches d, d + D, ... (the pad batches too)
        outs = []
        for fwd, d, dev in zip(forwards, local, devs):
            mine = []
            for i in range(d, len(staged), mesh.size):
                with trace.span(spans[1]):
                    mine.append(fwd(staged[i], embs[dev]))
            outs.append(mine)
        with trace.span(spans[2]):
            per = [torch.stack(mine).to(home) for mine in outs]
            shape = per[0].shape  # [batches per replica, rows, Q]
            every = distributed.gather_in_rank_order(
                torch.stack([p.reshape(-1) for p in per]), device="cpu"
            ).reshape((mesh.size,) + tuple(shape))
            stitched = torch.stack([every[i % mesh.size, i // mesh.size]
                                    for i in range(len(batches))])
            return _valid_rows(batches, stitched, mask_field)


def dp_predict_neighborhood_counts(params, tgt_cfg, query_embs: torch.Tensor,
                                   batches: List[PackedGraphs],
                                   mesh: DataMesh,
                                   staged: Optional[list] = None,
                                   graphed: bool = True,
                                   cache: Optional[ForwardCache] = None
                                   ) -> np.ndarray:
    """Stage-1 serving over the replicas: what the single-device
    ``predict_neighborhood_counts`` returns, bit for bit (valid rows of
    every batch, in batch order). ``query_embs`` lie on the master device;
    ``staged``: ``stage_batches_for_dp(batches, mesh)``. ``graphed``: each
    replica replays its compiled forward (``loop.neighborhood_forward``)
    from ``cache`` (a fresh one if None), which keeps the replicas'
    parameter copies: a replica's forward crosses no device, so replicas
    on several cards each get a graph on their own card, and replicas on
    one card share one."""
    from ..train.loop import neighborhood_forward

    if not batches:
        return np.zeros((0, int(query_embs.shape[0])), np.float32)

    def make(p, g, c):
        return neighborhood_forward(p, tgt_cfg, g, c)

    return _dp_predict(make, params, query_embs, batches, mesh,
                       "graph_mask", staged, graphed, cache, STAGE1_SPANS)


def dp_predict_gossip_counts(params, query_embs: torch.Tensor,
                             batches: List[PackedGraphs],
                             mesh: DataMesh, graphed: bool = True,
                             cache: Optional[ForwardCache] = None
                             ) -> np.ndarray:
    """Stage-3 serving over the replicas (one gossip batch per replica
    per group), bit-equal to the single-device ``predict_gossip_counts``
    (``graphed`` and ``cache`` as in ``dp_predict_neighborhood_counts``)."""
    from ..train.loop import gossip_forward

    if not batches:
        return np.zeros((0, int(query_embs.shape[0])), np.float32)
    return _dp_predict(gossip_forward, params, query_embs, batches, mesh,
                       "node_mask", None, graphed, cache, GOSSIP_SPANS)
