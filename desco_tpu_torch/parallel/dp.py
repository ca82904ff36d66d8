"""Data parallelism over a list of replicas — the port of
``desco_tpu/parallel/dp.py``.

desco_tpu runs each device's batch under ``shard_map`` over a ``data``
mesh axis and lets ``psum`` reduce the gradients. Here one controller
holds the replicas as a list (the design of parallel/halo.py): replica d
sits on ``mesh.devices[d]``, the devices cycling over the visible CUDA
devices (``shard_devices``), so D replicas run on one card, and on the
CPU all of them share it. ``psum`` over ``data`` is an explicit
reduction:

  1. each replica computes its gradients with ``torch.autograd.grad`` on
     its own batch;
  2. the gradients are summed on the master device (the parameters')
     in replica order, so the result is the same bits every run;
  3. one Adam step runs on the master parameters;
  4. a replica on another device gets the master parameters copied in
     before its next forward (``ReplicaParams``); replicas on the
     master's device use the master module itself. No gradient crosses
     devices through autograd, whose order of accumulation is not fixed.

The training loop (train/loop.Steps) captures a whole DP step, the
replicas' forwards and gradients and the sum, as one CUDA graph where
the replicas share one card; the replica generators are made once per
run and reseeded (``reseed_replica_generators``), so the graph keeps
reading them. A mesh over several cards trains with the eager step.

Gradient semantics are desco_tpu's:
  * ``"graphs"`` (neighborhood, a mean loss): the objective is
    sum_d loss_d * w_d / max(sum_d w_d, 1), w_d the replica's valid
    graph count, so all-masked pad batches weigh exactly 0;
  * ``"sum"`` (gossip, a sum loss): the objective is sum_d loss_d.

Prediction runs batch i on replica i % D, pads the batch list to a
multiple of D with all-masked copies of batch 0 (which run too, as in
desco_tpu), and stitches the valid rows back in batch order before the
one read-back: the result is bit-equal to the single-device predict
functions of train/loop.py. Serving and the CLI always predict here, on
a one-replica mesh when there is no data parallelism, and replay each
replica's compiled forward (desco_tpu jits its DP predicts).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..batch.packed import PackedGraphs, stack_batches
from ..utils.cuda_graphs import ForwardCache
from ..utils.device import resolve_device
from .halo import shard_devices


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """desco_tpu's ``data`` mesh: the device of every replica."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int = 0, device=None) -> DataMesh:
    """``n_devices`` replicas (0: one per visible CUDA device, one on the
    CPU) cycling over the visible CUDA devices, or all on the CPU for a
    CPU ``device`` (None means CUDA and raises without a GPU). The count
    is taken as given: 4 replicas on one card share it. One replica on a
    numbered CUDA device sits on that device."""
    device = resolve_device(device)
    if n_devices == 1 and device.index is not None:
        return DataMesh((device,))
    return DataMesh(tuple(shard_devices(n_devices, device)))


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
                  training: bool = False) -> List[PackedGraphs]:
    """Batch i on replica i % D's device, each device's batches moved in
    one stacked copy (``training`` keeps labels and the backward
    permutation)."""
    devs = [mesh.devices[i % mesh.size] for i in range(len(batches))]
    out: List[Optional[PackedGraphs]] = [None] * len(batches)
    for dev in dict.fromkeys(devs):
        idx = [i for i, d in enumerate(devs) if d == dev]
        stacked = stack_batches([batches[i] for i in idx]).to(
            dev, training=training)
        for j, i in enumerate(idx):
            out[i] = stacked[j]
    return out


def replica_seed(seed: int, d: int) -> int:
    """The dropout seed of replica d: desco_tpu folds ``axis_index('data')``
    into its key, and the two match in distribution only."""
    return (int(seed) * 1_000_003 + 7919 * (d + 1)) % (2 ** 63 - 1)


def replica_generators(mesh: DataMesh, seed: int) -> List[torch.Generator]:
    """One dropout generator per replica, on its device, seeded with
    ``replica_seed(seed, d)``."""
    return reseed_replica_generators(
        [torch.Generator(device=dev) for dev in mesh.devices], seed)


def reseed_replica_generators(generators: List[torch.Generator],
                              seed: int) -> List[torch.Generator]:
    """Seed replica d's generator with ``replica_seed(seed, d)`` in place:
    the state ``replica_generators(mesh, seed)`` starts from, on the same
    objects (a captured step keeps them registered)."""
    for d, gen in enumerate(generators):
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


def replica_loss_and_grads(
    losses: Callable[[int], torch.Tensor], replicas: list,
    home: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The explicit ``psum``: for replica d, ``losses(d)`` is its scalar
    objective term; its gradient is taken alone, then the terms and the
    gradients are summed on ``home`` in replica order."""
    total, flat = None, None
    for d, params in enumerate(replicas):
        obj = losses(d)
        g = _flat_grad(params, obj).to(home)
        obj = obj.detach().to(home)
        total = obj if total is None else total + obj
        flat = g if flat is None else flat + g
    return total, flat


def dp_loss_and_grads(loss_fn: Callable, params, group: Sequence,
                      mesh: DataMesh, weight_kind: str = "graphs",
                      generators: Optional[list] = None,
                      replicas: Optional[ReplicaParams] = None):
    """(global loss, reduced flat gradient) of one DP step on the master
    device. ``loss_fn(params, batch, generator) -> scalar``; ``group[d]``
    lies on ``mesh.devices[d]``."""
    if weight_kind not in ("graphs", "sum"):
        raise ValueError(f"weight_kind must be 'graphs' or 'sum', "
                         f"got {weight_kind!r}")
    if len(group) != mesh.size:
        raise ValueError(f"a DP step takes {mesh.size} batches, got "
                         f"{len(group)}")
    home = next(params.parameters()).device
    reps = (replicas or ReplicaParams()).sync(params, mesh.devices)
    gens = generators or [None] * mesh.size
    if weight_kind == "graphs":
        ws = [b.graph_mask.sum() for b in group]
        wsum = ws[0].to(home)
        for w in ws[1:]:
            wsum = wsum + w.to(home)
        wsum = torch.clamp(wsum, min=1.0)

        def losses(d):
            return (loss_fn(reps[d], group[d], gens[d]) * ws[d]
                    / wsum.to(ws[d].device))
    else:
        def losses(d):
            return loss_fn(reps[d], group[d], gens[d])
    return replica_loss_and_grads(losses, reps, home)


def apply_reduced(opt, loss: torch.Tensor, flat: torch.Tensor, lr):
    """One Adam step (train/loop.Adam) on a reduced gradient with
    ``train_step``'s non-finite guard on the global loss, kept on the
    device. Returns (loss, ok)."""
    opt.grad.copy_(flat)
    ok = torch.isfinite(loss)
    opt.step(lr, ok)
    return loss, ok


def dp_step_fn(loss_fn: Callable, opt, mesh: DataMesh,
               weight_kind: str = "graphs"):
    """A DP train step: ``step(params, group, lr, generators=None) ->
    (loss, ok)``, ``params`` the master module ``opt`` (train/loop.Adam)
    was made from, ``group`` one batch per replica on its device,
    ``generators`` one per replica (``replica_generators``). The reduced
    gradient lands in ``opt.grad`` (``apply_reduced``)."""
    replicas = ReplicaParams()

    def step(params, group, lr, generators=None):
        loss, flat = dp_loss_and_grads(loss_fn, params, group, mesh,
                                       weight_kind, generators, replicas)
        return apply_reduced(opt, loss, flat, lr)

    return step


# ------------------------------------------------------------ prediction
def stage_batches_for_dp(batches: List[PackedGraphs],
                         mesh: DataMesh) -> List[PackedGraphs]:
    """A request's batches padded to a multiple of D and placed on their
    replicas: the ``staged`` argument of the DP predict functions, which
    the members of an ensemble share."""
    return place_batches(pad_batches_to_multiple(list(batches), mesh.size),
                         mesh)


def _dp_predict(make_forward: Callable, params, query_embs: torch.Tensor,
                batches: List[PackedGraphs], mesh: DataMesh,
                mask_field: str, staged, graphed: bool, cache):
    from ..train.loop import _valid_rows

    home = query_embs.device
    if graphed and cache is None:
        cache = ForwardCache()
    with torch.inference_mode():
        if staged is None:
            staged = stage_batches_for_dp(batches, mesh)
        # a cache keeps its replicas' copies: its graphs read their storage
        if cache is not None and cache.replicas is None:
            cache.replicas = ReplicaParams()
        reps = (cache.replicas if cache is not None
                else ReplicaParams()).sync(params, mesh.devices)
        forwards = [make_forward(p, graphed, cache) for p in reps]
        embs = {dev: query_embs.to(dev) for dev in mesh.devices}
        preds = []
        for i, b in enumerate(staged):  # the pad batches run too
            d = i % mesh.size
            preds.append(forwards[d](b, embs[mesh.devices[d]]))
        stitched = torch.stack([p.to(home) for p in preds[:len(batches)]])
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
                       "graph_mask", staged, graphed, cache)


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
                       "node_mask", None, graphed, cache)
