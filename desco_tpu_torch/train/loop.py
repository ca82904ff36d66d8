"""Training loops and batched prediction — the port of
``desco_tpu/train/loop.py``: Adam with the learning rate as data and a
host-side plateau schedule, val-monitored best-checkpoint selection,
``.last`` snapshots with resume, and the predict functions of serving.

All batches of a run share one shape and live on the device for the whole
run (one stacked copy). The epoch replays compiled steps: the train step
(``carried_step``) and the eval step (``carried_eval``) of both stages
are captured once per run and shape as CUDA graphs (utils/cuda_graphs.py,
the counterpart of desco_tpu's ``step_jit`` and ``eval_jit``), every
resident batch's index streams and pooling offsets derived before the
first step (models/shmp_gnn.prepare_batch), and the graphed loops run
under ``set_sync_debug_mode("error")``. The gossip train step is one of
them: its loss draws each query's dropout masks ahead of the query's
checkpointed call (models/gossip.py), so no step rewinds a generator.
With a ``mesh`` (parallel/dp.py) a train step takes a group of D
batches, one per replica. Where a process's replicas share one card, in
one process or on each rank of a process group (utils/distributed.py),
it is ``dp.DPStep`` captured as two graphs, the process's replicas'
forwards and gradients (the group in static buffers, every replica's
generator registered) and the ordered sum with Adam, the exchange
between them (the gather across ranks). A mesh over several cards in
one process trains with the eager DP step (a capture records one
device), and the run's log says so. Validation runs the single-device
eval step, graphed, on every path; across ranks every rank runs it whole
and holds the same val loss, so the plateau schedule moves in step.
Rank 0 alone writes checkpoints and logs, the other ranks waiting at a
barrier; a resumed run loads the same file on every rank. On
the CPU, which only the tests ask for, the same static-buffer steps run
without a capture; ``graphed=False`` runs the eager steps instead.

What desco_tpu does inside its jitted, donated-carry step is kept on the
device in both, so an epoch reads back once:

  * the loss sum and the count of rejected steps accumulate in device
    scalars; one ``.item()`` per epoch is the completion barrier that
    times the train steps;
  * a step whose loss is not finite is REJECTED on the device: parameters,
    Adam moments and the step count keep their values through a
    ``torch.where`` on the finite flag (no host check per step), the step
    is counted, and the epoch raises ``FloatingPointError`` — the last
    on-disk snapshot stays clean and resumable.

Optimizer semantics are desco_tpu's ``make_adam`` (an optax chain that
mirrors torch.optim.Adam: optional L2 weight decay added to the gradient,
Adam direction, then the learning rate). optax updates every leaf, also
one that got no gradient (the gossip ``pre`` layer behind its detach
still decays under weight decay), where torch.optim.Adam skips a
parameter whose ``.grad`` is None. ``Adam`` here keeps all parameters
and all gradients as views of one flat buffer each: every parameter
always has a gradient (zero when autograd wrote none), and the update is
a handful of elementwise kernels whatever the number of tensors.

Dropout masks come from one ``torch.Generator`` on the device (one per
replica with a ``mesh``), made once per run and reseeded from (seed,
epoch) at the start of every epoch, so a resumed run draws the masks an
uninterrupted run would and a captured step keeps reading the same
generators. The batch order comes from
``np.random.default_rng(seed + 1).permutation``, the same numpy stream as
desco_tpu's: both packages visit the batches in the same order, and a
resumed run replays the draws of the epochs it skips.

A request's packed batches are consecutive views of one host block
(``pack_samples``), so they move to the device in one copy; prediction
dispatches every batch before the one read-back at the end. The predict
functions replay compiled forwards (desco_tpu's ``_jit_predict_from_embs``
and ``_jit_gossip_predict``): a ``graphed.ForwardCache`` keyed by the
parameters, the config and the batch shape, each batch's streams and
pooling offsets derived before its replay; ``graphed=False`` runs them
eagerly.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..batch.packed import PAD_EDGE_TYPE, PackedGraphs, stack_batches
from ..models import gossip as gossip_mod
from ..models import neighborhood as neigh_mod
from ..models.shmp_gnn import SHMPConfig, prepare_batch
from ..parallel import dp
from ..utils import distributed, trace
from ..utils.device import resolve_device
from .checkpoint import jax_keys, load_checkpoint, save_checkpoint
from ..utils.cuda_graphs import ForwardCache, GraphedStep, no_sync
from .schedule import ReduceLROnPlateau


# ------------------------------------------------------------------ Adam
class Adam:
    """desco_tpu's ``make_adam`` for a parameter module (see module docs).

    ``step(lr, ok)`` applies one update in place; where the device flag
    ``ok`` is false it leaves parameters, moments and count untouched."""

    def __init__(self, params: nn.Module, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        params.requires_grad_(True)
        named = list(params.named_parameters())
        if not named:
            raise ValueError("no parameters to optimize")
        dev = named[0][1].device
        if any(p.device != dev or p.dtype != torch.float32
               for _, p in named):
            raise ValueError("Adam wants float32 parameters on one device")
        self.weight_decay, self.b1, self.b2, self.eps = (
            weight_decay, b1, b2, eps)
        with torch.no_grad():
            self.flat = torch.cat([p.detach().reshape(-1) for _, p in named])
        self.grad = torch.zeros_like(self.flat)
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.float32, device=dev)
        self._b1 = torch.tensor(b1, dtype=torch.float32, device=dev)
        self._b2 = torch.tensor(b2, dtype=torch.float32, device=dev)
        self._slices: Dict[str, tuple] = {}
        self._params = [p for _, p in named]
        keys = jax_keys(params)
        off = 0
        for name, p in named:
            n = p.numel()
            p.data = self.flat[off:off + n].view(p.shape)
            p.grad = self.grad[off:off + n].view(p.shape)
            self._slices[keys[name]] = (off, off + n, tuple(p.shape))
            off += n

    def zero_grad(self) -> None:
        self.grad.zero_()

    def _check_grads(self) -> None:
        """Every parameter's gradient must still be its f32 view of the
        flat gradient buffer: a tower that runs in bf16 casts inside its
        forward, so autograd hands the f32 masters f32 gradients; a
        gradient that was replaced, or that came in another type, would
        leave the flat buffer stale."""
        base = self.grad.data_ptr()
        for p, (lo, _, _) in zip(self._params, self._slices.values()):
            g = p.grad
            if (g is None or g.dtype != torch.float32
                    or g.data_ptr() != base + 4 * lo):
                raise RuntimeError(
                    "Adam: a parameter's gradient is no longer the float32 "
                    "view of the flat gradient buffer")

    @torch.no_grad()
    def step(self, lr, ok: Optional[torch.Tensor] = None) -> None:
        """``lr``: a float, or a 0-d float32 tensor on the parameters'
        device (the same product either way). Every state tensor is
        updated in place, so a captured step (utils/cuda_graphs.py) updates
        the live ones."""
        self._check_grads()
        g = self.grad
        if self.weight_decay:
            g = g + self.weight_decay * self.flat
        count = self.count + 1.0
        mu = (1.0 - self.b1) * g + self.b1 * self.mu
        nu = (1.0 - self.b2) * (g * g) + self.b2 * self.nu
        bc1 = 1.0 - torch.pow(self._b1, count)
        bc2 = 1.0 - torch.pow(self._b2, count)
        new = self.flat - lr * ((mu / bc1) / (torch.sqrt(nu / bc2)
                                              + self.eps))
        if ok is not None:
            new = torch.where(ok, new, self.flat)
            mu = torch.where(ok, mu, self.mu)
            nu = torch.where(ok, nu, self.nu)
            count = torch.where(ok, count, self.count)
        self.flat.copy_(new)  # the parameters are views of it
        self.mu.copy_(mu)
        self.nu.copy_(nu)
        self.count.copy_(count)

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a step updates in place."""
        return [self.flat, self.grad, self.mu, self.nu, self.count]

    def state_arrays(self) -> Dict[str, np.ndarray]:
        """The state in the ``.opt.npz`` layout (train/checkpoint.py)."""
        out = {"count": np.asarray(int(self.count.item()), np.int64)}
        for name, buf in (("mu", self.mu), ("nu", self.nu)):
            host = buf.cpu().numpy()
            for key, (lo, hi, shape) in self._slices.items():
                out[f"{name}/{key}"] = host[lo:hi].reshape(shape)
        return out

    def load_state_arrays(self, state: Dict[str, np.ndarray]) -> None:
        """Load the ``.opt.npz`` layout into the state tensors, in place."""
        self.count.fill_(float(state["count"]))
        for name in ("mu", "nu"):
            host = np.zeros(self.flat.numel(), np.float32)
            for key, (lo, hi, shape) in self._slices.items():
                arr = np.asarray(state[f"{name}/{key}"], np.float32)
                if arr.shape != shape:
                    raise ValueError(f"optimizer state {name}/{key} has "
                                     f"shape {arr.shape}, not {shape}")
                host[lo:hi] = arr.reshape(-1)
            getattr(self, name).copy_(torch.from_numpy(host))


def make_adam(params: nn.Module, weight_decay: float = 0.0) -> Adam:
    """torch.optim.Adam's update with the LR applied by the caller."""
    return Adam(params, weight_decay)


@dataclasses.dataclass
class TrainResult:
    params: nn.Module
    best_params: nn.Module
    train_losses: List[float]
    val_losses: List[float]
    best_val: float
    epoch_times: List[float]
    # seconds of the train steps alone per epoch (the val pass excluded)
    train_times: List[float] = dataclasses.field(default_factory=list)


def train_step(params, opt: Adam, loss_fn: Callable, batch: PackedGraphs,
               lr, generator: Optional[torch.Generator]):
    """One step: loss, backward, guarded Adam update. Returns the detached
    loss and the device flag of a finite loss."""
    opt.zero_grad()
    loss = loss_fn(params, batch, generator)
    loss.backward()
    loss = loss.detach()
    ok = torch.isfinite(loss)
    opt.step(lr, ok)
    return loss, ok


def carried_step(params, opt: Adam, loss_fn: Callable, lr,
                 generator: Optional[torch.Generator], carry):
    """fn(batch): desco_tpu's ``carried_step``, a ``train_step`` that adds
    its loss (0 where rejected) and its rejection to ``carry`` = (loss
    sum, count of rejected steps), two device scalars, in place."""

    def step(batch):
        _carry(carry, *train_step(params, opt, loss_fn, batch, lr,
                                  generator))

    return step


def carried_dp_step(params, dp_step: Callable, lr, generators: list,
                    carry):
    """fn(group): ``carried_step`` for a DP step (``dp.DPStep``) over
    a group of D batches, one per replica, drawing from ``generators``."""

    def step(group):
        _carry(carry, *dp_step(params, group, lr, generators))

    return step


def _carry(carry, loss, ok) -> None:
    carry[0].add_(torch.where(ok, loss, torch.zeros_like(loss)))
    carry[1].add_((~ok).long())


def carried_eval(params, eval_fn: Callable, carry):
    """fn(batch): desco_tpu's ``eval_step``, ``eval_fn``'s (weighted loss,
    weight) added to ``carry``, two device scalars, in place."""

    def step(batch):
        with torch.no_grad():
            s_, w_ = eval_fn(params, batch)
        carry[0].add_(s_)
        carry[1].add_(w_)

    return step


class Steps:
    """The train and eval steps of a run over same-shape resident batches,
    with their device carries. ``graphed``: both steps on static buffers,
    captured once as CUDA graphs on a CUDA device (utils/cuda_graphs.py),
    after ``prepare(batch, backward)`` has derived every batch's
    per-batch state; else the eager steps. ``lr``: the device scalar the
    steps read. With a ``mesh`` (parallel/dp.py) ``train_dev`` holds
    groups of D batches and the train step is the DP step, its replica
    generators made here (``generators``); it is ``dp.DPStep``, graphed
    (split at the gather across ranks) where this process's replicas
    share one device, eager, saying so through ``log_fn``, where they lie
    on several. ``reseed`` seeds the generators."""

    def __init__(self, params, opt: Adam, loss_fn: Callable,
                 eval_fn: Callable, train_dev, val_dev, lr, generator,
                 device, *, graphed: bool,
                 prepare: Optional[Callable] = None, mesh=None,
                 weight_kind: str = "graphs", log_fn=print):
        device = torch.device(device)
        self.mesh = mesh
        cards = 1 if mesh is None else len({mesh.devices[d]
                                            for d in mesh.local})
        self.train_carry = (torch.zeros((), device=device),
                            torch.zeros((), dtype=torch.int64,
                                        device=device))
        self.eval_carry = (torch.zeros((), device=device),
                           torch.zeros((), device=device))
        if mesh is None:
            self.generators = [generator] if generator is not None else []
            self.train = carried_step(params, opt, loss_fn, lr, generator,
                                      self.train_carry)
        else:
            self.generators = dp.replica_generators(mesh, 0)
            dp_step = dp.DPStep(loss_fn, opt, mesh, weight_kind,
                                graphed=graphed and cards == 1)
            self.train = carried_dp_step(params, dp_step, lr,
                                         self.generators, self.train_carry)
        self.eval = carried_eval(params, eval_fn, self.eval_carry)
        self.capture = graphed and device.type == "cuda"
        # a step with no exchange across ranks reads nothing back
        self.train_sync_free = self.capture and cards == 1 and (
            mesh is None or mesh.world == 1)
        if not graphed:
            return
        if prepare is not None:
            for b in train_dev:
                for one in (b if mesh is not None else [b]):
                    if isinstance(one, PackedGraphs):  # not another rank's
                        prepare(one, True)
            for b in val_dev or ():
                prepare(b, False)
        if mesh is None:
            self.train = GraphedStep(
                self.train, train_dev[0], capture=self.capture,
                generators=self.generators,
                state=opt.state_tensors() + list(self.train_carry))
        elif cards == 1:
            dp_step.prepare(params, train_dev[0], self.generators)
        else:
            log_fn(f"the DP train step over {cards} devices runs eager: a "
                   f"captured step records one device")
        if val_dev:
            self.eval = GraphedStep(self.eval, val_dev[0],
                                    capture=self.capture,
                                    state=self.eval_carry)

    def reseed(self, seed: int) -> None:
        """Seed the dropout generators in place (one per replica with a
        mesh, ``dp.replica_seed``), as a captured step reads them."""
        if self.mesh is None:
            for g in self.generators:
                g.manual_seed(seed)
        else:
            dp.reseed_replica_generators(self.generators, seed)

    def _run(self, step, carry, batches, order, sync_free) -> None:
        for t in carry:
            t.zero_()
        with no_sync(carry[0].device) if sync_free else \
                contextlib.nullcontext():
            for bi in order:
                step(batches[int(bi)])

    def train_epoch(self, batches, order):
        """The train steps over ``batches`` (groups with a mesh) in
        ``order``: (loss sum, count of rejected steps) on the device."""
        self._run(self.train, self.train_carry, batches, order,
                  self.train_sync_free)
        return self.train_carry

    def val_loss(self, batches) -> float:
        """The weighted mean eval loss over ``batches`` (one read-back)."""
        self._run(self.eval, self.eval_carry, batches, range(len(batches)),
                  self.capture and isinstance(self.eval, GraphedStep))
        s_sum, w_sum = self.eval_carry
        return float(s_sum) / max(float(w_sum), 1.0)

def _epoch_seed(seed: int, epoch: int) -> int:
    return (int(seed) * 1_000_003 + int(epoch)) % (2 ** 63 - 1)


# ---------------------------------------------------------------- generic
def run_training(
    *, params: nn.Module, opt: Adam,
    train_batches: List[PackedGraphs], val_batches: List[PackedGraphs],
    loss_fn: Callable, eval_fn: Callable, epochs: int, lr: float,
    device, min_lr: float = 1e-5, factor: float = 0.5, patience: int = 20,
    seed: int = 0, ckpt_path: Optional[str] = None,
    ckpt_config: Optional[dict] = None,
    log_every: int = 10, log_fn=print, mesh=None,
    weight_kind: str = "graphs",
    resume: bool = False, snapshot_every: int = 10,
    val_every: int = 1, graphed: bool = True,
    prepare: Optional[Callable] = None,
) -> TrainResult:
    """Generic loop: ``loss_fn(params, batch, generator) -> loss`` and
    ``eval_fn(params, batch) -> (loss_sum, weight)`` over batches on
    ``device``; ``params`` lie there and ``opt`` was made from them.

    ``graphed``: the compiled steps of ``Steps``, captured as CUDA graphs
    on a CUDA device, static-buffer steps without a capture on the CPU;
    ``prepare(batch, backward)`` derives a resident batch's per-batch
    state before the first step (the towers' streams and pooling
    offsets, models/shmp_gnn.prepare_batch). ``graphed=False`` runs the
    eager steps.

    A ``mesh`` (parallel/dp.make_mesh) trains data-parallel: the train
    batches are padded to a multiple of its D replicas and grouped D at a
    time, each step reduces the replicas' gradients with ``weight_kind``
    semantics (parallel/dp.py), and the epoch's train loss is the mean
    over the groups, as in desco_tpu.

    Full training state (params + optimizer + plateau scheduler + epoch)
    snapshots to ``<ckpt_path>.last`` every ``snapshot_every`` epochs;
    ``resume=True`` continues from it. In a process group rank 0 alone
    logs and writes the checkpoints, every rank passing a barrier after
    each write; every rank resumes from the same files."""
    device = torch.device(device)
    lead = distributed.rank() == 0
    if not lead:
        def log_fn(*_):
            return None

    def save(path, *a, **kw):
        if lead:
            save_checkpoint(path, *a, **kw)
        distributed.barrier()

    # live (non-pad) edges per epoch, for the per-epoch edges/s counter,
    # counted before the DP padding (pad batches carry real edge types)
    epoch_edges = int(sum(
        (np.asarray(b.edge_type) != PAD_EDGE_TYPE).sum()
        for b in train_batches))

    # move the batches to the device ONCE (one stacked copy); the epoch
    # loops over resident batches, whose index streams
    # (models/shmp_gnn.batch_typed_streams) are derived before the first
    # graphed step, or at first use by an eager one
    def to_device_list(batches):
        stacked = stack_batches(batches).to(device, training=True)
        return [stacked[i] for i in range(len(batches))]

    if mesh is None:
        train_dev = to_device_list(train_batches)
    else:
        # a step takes a group of D batches, each resident on its
        # replica's device; validation stays on ``device``
        d_n = mesh.size
        train_dev = dp.reshape_for_dp(dp.place_batches(
            dp.pad_batches_to_multiple(list(train_batches), d_n), mesh,
            training=True), d_n)
    val_dev = to_device_list(val_batches) if val_batches else None
    n_train = len(train_dev)

    sched = ReduceLROnPlateau(lr=lr, factor=factor, patience=patience,
                              min_lr=min_lr)
    # the learning rate as data (desco_tpu's lr_dev): a plateau decay
    # writes it in place and recaptures nothing
    lr_dev = torch.tensor(float(lr), dtype=torch.float32, device=device)
    best_val = float("inf")
    best_params = copy.deepcopy(params)
    train_losses, val_losses, times, train_times = [], [], [], []
    start_epoch = 0

    if resume and ckpt_path and os.path.exists(
            ckpt_path + ".last.params.npz"):
        loaded, opt_state, meta = load_checkpoint(ckpt_path + ".last",
                                                  with_opt_state=True)
        params.load_state_dict(loaded.state_dict())  # in place
        if opt_state is not None:
            opt.load_state_arrays(opt_state)
        ex = meta.get("extra", {})
        start_epoch = int(ex.get("epoch", -1)) + 1
        for k in ("lr", "best", "num_bad"):
            if k in ex:
                setattr(sched, k, ex[k])
        best_val = float(ex.get("best_val", best_val))
        if os.path.exists(ckpt_path + ".best.params.npz"):
            best_params = load_checkpoint(ckpt_path + ".best")[0].to(device)
        log_fn(f"resumed from epoch {start_epoch} (lr {sched.lr:.2e}, "
               f"best_val {best_val:.5f})")

    t0 = time.time()
    steps = Steps(params, opt, loss_fn, eval_fn, train_dev, val_dev, lr_dev,
                  torch.Generator(device=device), device, graphed=graphed,
                  prepare=prepare, mesh=mesh, weight_kind=weight_kind,
                  log_fn=log_fn)
    if steps.capture:
        log_fn(f"compiled steps: batches prepared and the steps captured "
               f"as CUDA graphs in {time.time() - t0:.2f}s")

    def val_loss() -> float:
        if val_dev is None:
            return float("nan")
        return steps.val_loss(val_dev)

    where = ckpt_path + ".last" if ckpt_path else "scratch"
    rng_np = np.random.default_rng(seed + 1)
    # a resumed run must CONTINUE the shuffle stream, not restart it:
    # replay the draws the completed epochs consumed
    for _ in range(start_epoch):
        rng_np.permutation(n_train)
    for epoch in range(start_epoch, epochs):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.time()
        steps.reseed(_epoch_seed(seed, epoch))
        order = rng_np.permutation(n_train)
        lr_dev.fill_(sched.lr)
        loss_sum, n_bad = steps.train_epoch(train_dev, order)
        n_bad = int(n_bad.item())  # the epoch's one read-back barrier
        if n_bad:
            msg = (f"epoch {epoch}: {n_bad}/{n_train} train steps "
                   f"produced a non-finite loss; their updates were "
                   f"rejected. Aborting (resume from {where}).")
            log_fn(msg)
            raise FloatingPointError(msg)
        tl = float(loss_sum) / n_train
        t_train = time.time() - t0  # covers exactly the train steps
        # val cadence: with val_every=k the val pass runs every k epochs;
        # the plateau scheduler and best-checkpoint monitor only see
        # those epochs (patience counts monitored values, not epochs)
        run_val = (val_dev is None or val_every <= 1
                   or epoch % val_every == 0 or epoch == epochs - 1)
        vl = val_loss() if run_val else float("nan")
        times.append(time.time() - t0)
        train_times.append(t_train)
        train_losses.append(tl)
        val_losses.append(vl)
        if run_val:
            if val_dev is not None and not np.isfinite(vl):
                # a val pass that RAN and produced a non-finite loss must
                # not be replaced by the train loss
                msg = (f"epoch {epoch}: validation loss is {vl}; "
                       f"aborting (resume from {where}).")
                log_fn(msg)
                raise FloatingPointError(msg)
            # the train-loss fallback is for runs with NO val set only
            monitored = vl if np.isfinite(vl) else tl
            sched.step(monitored)
            if monitored < best_val:
                best_val = monitored
                best_params = copy.deepcopy(params)
                if ckpt_path:
                    save(
                        ckpt_path + ".best", best_params,
                        config=ckpt_config,
                        extra={"epoch": epoch, "val_loss": best_val})
        if log_every and (epoch % log_every == 0 or epoch == epochs - 1):
            log_fn(f"epoch {epoch:4d} train {tl:.5f} val {vl:.5f} "
                   f"lr {sched.lr:.2e} {times[-1]:.2f}s "
                   f"{epoch_edges / max(t_train, 1e-9) / 1e6:.1f}M edges/s")
        if ckpt_path and snapshot_every and (
                epoch % snapshot_every == 0 or epoch == epochs - 1):
            save(
                ckpt_path + ".last", params, config=ckpt_config,
                opt_state=opt.state_arrays(),
                extra={"epoch": epoch, "lr": sched.lr,
                       "best": sched.best, "num_bad": sched.num_bad,
                       "best_val": best_val})
    return TrainResult(params, best_params, train_losses, val_losses,
                       best_val, times, train_times)


def _follow(value, device):
    """fn(device) -> ``value`` (a tensor or a device ``PackedGraphs`` on
    ``device``) there: itself on its own device, else a copy made once
    per device. The DP loss functions read their query batch or
    embeddings where a replica's batch lies."""
    copies = {torch.device(device): value}

    def on(dev):
        if dev not in copies:
            copies[dev] = (value.to(dev) if isinstance(value, torch.Tensor)
                           else PackedGraphs(**{n: v.to(dev)
                                                for n, v in value.fields()}))
        return copies[dev]

    return on


# ----------------------------------------------------------- neighborhood
def neighborhood_loss_fn(tgt_cfg, qry_cfg, query_batch):
    qb_on = _follow(query_batch, query_batch.x.device)

    def f(params, batch, generator):
        return neigh_mod.train_loss(params, tgt_cfg, qry_cfg, batch,
                                    qb_on(batch.x.device),
                                    generator=generator)

    return f


def neighborhood_eval_fn(tgt_cfg, qry_cfg, query_batch):
    def eval_one(params, batch):
        # weighted by valid-graph count so the epoch metric is the true mean
        loss = neigh_mod.train_loss(params, tgt_cfg, qry_cfg, batch,
                                    query_batch)
        w = batch.graph_mask.sum()
        return loss * w, w

    return eval_one


def train_neighborhood(
    params, tgt_cfg: SHMPConfig, qry_cfg: SHMPConfig,
    query_batch: PackedGraphs, train_batches, val_batches, *,
    epochs=300, lr=1e-4, weight_decay=0.0, ckpt_path=None,
    ckpt_config=None, mesh=None, eval_tgt_cfg=None, device=None, **kw,
) -> TrainResult:
    """Train the two towers and the count head. ``device``: None or
    "cuda" train on the GPU (and raise when none is visible), "cpu" on
    the CPU. ``params`` move there and are updated in place.
    ``eval_tgt_cfg`` is the tower config of the val passes (default
    ``tgt_cfg``). A ``mesh`` trains data-parallel with the ``"graphs"``
    weighting (``run_training``)."""
    device = resolve_device(device)
    params = params.to(device)
    qb = query_batch.to(device)
    # the query tower runs in every step: its batch's state too
    prepare_batch(qb, qry_cfg.n_edge_types, backward=True)
    return run_training(
        params=params, opt=make_adam(params, weight_decay),
        train_batches=train_batches, val_batches=val_batches,
        loss_fn=neighborhood_loss_fn(tgt_cfg, qry_cfg, qb),
        eval_fn=neighborhood_eval_fn(eval_tgt_cfg or tgt_cfg, qry_cfg, qb),
        epochs=epochs, lr=lr, ckpt_path=ckpt_path,
        ckpt_config=ckpt_config, mesh=mesh, weight_kind="graphs",
        device=device, prepare=lambda b, backward: prepare_batch(
            b, tgt_cfg.n_edge_types, backward), **kw)


# ---------------------------------------------------------------- gossip
def gossip_loss_fn(dropout: float, query_embs: torch.Tensor):
    embs_on = _follow(query_embs, query_embs.device)

    def f(params, batch, generator):
        return gossip_mod.gossip_loss(params, batch, embs_on(batch.x.device),
                                      dropout, True, generator)

    return f


def gossip_prepare(batch: PackedGraphs, backward: bool) -> None:
    """A gossip batch's per-batch state: its direction streams (T = 2)."""
    prepare_batch(batch, 2, backward, pooling=False)


def gossip_eval_fn(query_embs: torch.Tensor):
    def eval_one(params, batch):
        # gossip_loss is a SUM over valid (node, query) terms; weight by
        # the valid-node count so the epoch metric is a per-node mean,
        # stable under re-batching
        loss = gossip_mod.gossip_loss(params, batch, query_embs)
        return loss, batch.node_mask.sum()

    return eval_one


def train_gossip(
    params, query_embs: torch.Tensor, train_batches, val_batches, *,
    epochs=30, lr=1e-3, weight_decay=0.0, dropout=0.01,
    ckpt_path=None, ckpt_config=None, mesh=None, device=None, **kw,
) -> TrainResult:
    """Train the gossip model against fixed query embeddings (``device``
    as in ``train_neighborhood``; a ``mesh`` with the ``"sum"``
    weighting)."""
    device = resolve_device(device)
    params = params.to(device)
    query_embs = query_embs.detach().to(device)
    return run_training(
        params=params, opt=make_adam(params, weight_decay),
        train_batches=train_batches, val_batches=val_batches,
        loss_fn=gossip_loss_fn(dropout, query_embs),
        eval_fn=gossip_eval_fn(query_embs),
        epochs=epochs, lr=lr, ckpt_path=ckpt_path,
        ckpt_config=ckpt_config, mesh=mesh, weight_kind="sum",
        device=device, prepare=gossip_prepare, **kw)


# ------------------------------------------------------------- prediction
def _valid_rows(batches: List[PackedGraphs], preds: torch.Tensor,
                mask_field: str) -> np.ndarray:
    all_preds = preds.cpu().numpy()
    out = [p[np.asarray(getattr(b, mask_field)) > 0]
           for b, p in zip(batches, all_preds)]
    return np.concatenate(out, axis=0)


def neighborhood_forward(params, tgt_cfg, graphed: bool = True,
                         cache: Optional[ForwardCache] = None) -> Callable:
    """fn(batch, query_embs) -> [g_cap, Q] de-logged stage-1 counts of a
    device batch, desco_tpu's ``_jit_predict_from_embs``. ``graphed``: the
    forward replays from ``cache`` (a fresh one if None), keyed by
    ``params``, ``tgt_cfg`` and the shapes, each batch's streams and
    pooling offsets derived first (``prepare_batch``; deriving reads back,
    which no capture holds); else it runs eagerly."""

    def forward(b, e):
        return neigh_mod.predict_counts_from_embs(params, tgt_cfg, b, e)

    return _compiled(
        forward, lambda b: prepare_batch(b, tgt_cfg.n_edge_types, False),
        ("neighborhood", id(params), tgt_cfg), graphed, cache)


def gossip_forward(params, graphed: bool = True,
                   cache: Optional[ForwardCache] = None) -> Callable:
    """fn(batch, query_embs) -> [n_cap, Q] refined counts of a device
    gossip batch, desco_tpu's ``_jit_gossip_predict``: the 29-query loop
    and the direction degrees inside one forward (``graphed`` as in
    ``neighborhood_forward``; the batch's direction streams derived
    first)."""

    def forward(b, e):
        return gossip_mod.gossip_predict(params, b, e)

    return _compiled(forward, lambda b: gossip_prepare(b, False),
                     ("gossip", id(params)), graphed, cache)


def _compiled(forward: Callable, prepare: Callable, static, graphed: bool,
              cache: Optional[ForwardCache]) -> Callable:
    """fn(batch, query_embs): ``forward`` replayed from ``cache`` under
    ``static``, ``prepare(batch)`` first, one forward per bucket (the
    batch's graph slots and the query count); ``forward`` itself when not
    ``graphed``."""
    if not graphed:
        return forward
    cache = cache if cache is not None else ForwardCache()

    def run(b, e):
        # deriving the batch's state reads back (a synchronize)
        with trace.span("forward.derive"):
            prepare(b)
        return cache(forward, (b, e), static=static,
                     group=(b.g_cap, e.shape[0]))

    return run


def predict_neighborhood_counts(params, tgt_cfg, query_embs: torch.Tensor,
                                batches: List[PackedGraphs], device,
                                graphed: bool = True,
                                cache: Optional[ForwardCache] = None
                                ) -> np.ndarray:
    """(#valid graphs over all batches, Q) de-logged stage-1 counts.
    ``query_embs`` ([Q, H] on ``device``, ``embed_queries``) come from the
    query tower, which a service runs once: the query set is static.
    Serving runs parallel/dp.py's counterpart, bit-equal to this.
    ``graphed`` and ``cache``: ``neighborhood_forward``."""
    run = neighborhood_forward(params, tgt_cfg, graphed, cache)
    with torch.inference_mode():
        stacked = stack_batches(batches).to(device)
        preds = torch.stack([run(stacked[bi], query_embs)
                             for bi in range(len(batches))])  # [B, g_cap, Q]
        return _valid_rows(batches, preds, "graph_mask")


def predict_gossip_counts(params, query_embs: torch.Tensor,
                          batches: List[PackedGraphs], device,
                          graphed: bool = True,
                          cache: Optional[ForwardCache] = None
                          ) -> np.ndarray:
    """(#total_nodes, Q) refined per-node counts in node order
    (``gossip_forward``)."""
    run = gossip_forward(params, graphed, cache)
    with torch.inference_mode():
        stacked = stack_batches(batches).to(device)
        preds = torch.stack([run(stacked[bi], query_embs)
                             for bi in range(len(batches))])  # [B, n_cap, Q]
        return _valid_rows(batches, preds, "node_mask")
