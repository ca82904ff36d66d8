"""Training loops and batched prediction — the port of
``desco_tpu/train/loop.py``: Adam with the learning rate as data and a
host-side plateau schedule, val-monitored best-checkpoint selection,
``.last`` snapshots with resume, and the predict functions of serving.

All batches of a run share one shape and live on the device for the whole
run (one stacked copy); the epoch is a Python loop over eager steps. What
desco_tpu does inside its jitted, donated-carry step is kept on the device
here too, so an epoch reads back once:

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

Dropout masks come from one ``torch.Generator`` on the device, reseeded
from (seed, epoch) at the start of every epoch, so a resumed run draws
the masks an uninterrupted run would. The batch order comes from
``np.random.default_rng(seed + 1).permutation``, the same numpy stream as
desco_tpu's: both packages visit the batches in the same order, and a
resumed run replays the draws of the epochs it skips.

A request's packed batches are consecutive views of one host block
(``pack_samples``), so they move to the device in one copy; prediction
dispatches every batch before the one read-back at the end.
"""

from __future__ import annotations

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
from ..models.shmp_gnn import SHMPConfig
from ..utils.device import resolve_device
from .checkpoint import jax_key, load_checkpoint, save_checkpoint
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
        self._slices: Dict[str, tuple] = {}
        off = 0
        for name, p in named:
            n = p.numel()
            p.data = self.flat[off:off + n].view(p.shape)
            p.grad = self.grad[off:off + n].view(p.shape)
            self._slices[jax_key(name)] = (off, off + n, tuple(p.shape))
            off += n

    def zero_grad(self) -> None:
        self.grad.zero_()

    @torch.no_grad()
    def step(self, lr: float, ok: Optional[torch.Tensor] = None) -> None:
        g = self.grad
        if self.weight_decay:
            g = g + self.weight_decay * self.flat
        count = self.count + 1.0
        mu = (1.0 - self.b1) * g + self.b1 * self.mu
        nu = (1.0 - self.b2) * (g * g) + self.b2 * self.nu
        bc1 = 1.0 - torch.pow(count.new_tensor(self.b1), count)
        bc2 = 1.0 - torch.pow(count.new_tensor(self.b2), count)
        new = self.flat - lr * ((mu / bc1) / (torch.sqrt(nu / bc2)
                                              + self.eps))
        if ok is not None:
            new = torch.where(ok, new, self.flat)
            mu = torch.where(ok, mu, self.mu)
            nu = torch.where(ok, nu, self.nu)
            count = torch.where(ok, count, self.count)
        self.flat.copy_(new)  # in place: the parameters are views of it
        self.mu, self.nu, self.count = mu, nu, count

    def state_arrays(self) -> Dict[str, np.ndarray]:
        """The state in the ``.opt.npz`` layout (train/checkpoint.py)."""
        out = {"count": np.asarray(int(self.count.item()), np.int64)}
        for name, buf in (("mu", self.mu), ("nu", self.nu)):
            host = buf.cpu().numpy()
            for key, (lo, hi, shape) in self._slices.items():
                out[f"{name}/{key}"] = host[lo:hi].reshape(shape)
        return out

    def load_state_arrays(self, state: Dict[str, np.ndarray]) -> None:
        self.count = self.count.new_tensor(float(state["count"]))
        for name in ("mu", "nu"):
            host = np.zeros(self.flat.numel(), np.float32)
            for key, (lo, hi, shape) in self._slices.items():
                arr = np.asarray(state[f"{name}/{key}"], np.float32)
                if arr.shape != shape:
                    raise ValueError(f"optimizer state {name}/{key} has "
                                     f"shape {arr.shape}, not {shape}")
                host[lo:hi] = arr.reshape(-1)
            setattr(self, name, torch.from_numpy(host).to(self.flat.device))


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
               lr: float, generator: Optional[torch.Generator]):
    """One step: loss, backward, guarded Adam update. Returns the detached
    loss and the device flag of a finite loss. A checkpointed loss
    (gossip) rewinds the generator while it recomputes, so its state
    after the forward is put back after the backward."""
    opt.zero_grad()
    loss = loss_fn(params, batch, generator)
    end = generator.get_state() if generator is not None else None
    loss.backward()
    if generator is not None:
        generator.set_state(end)
    loss = loss.detach()
    ok = torch.isfinite(loss)
    opt.step(lr, ok)
    return loss, ok


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
    resume: bool = False, snapshot_every: int = 10,
    val_every: int = 1,
) -> TrainResult:
    """Generic loop: ``loss_fn(params, batch, generator) -> loss`` and
    ``eval_fn(params, batch) -> (loss_sum, weight)`` over batches on
    ``device``; ``params`` lie there and ``opt`` was made from them.

    Full training state (params + optimizer + plateau scheduler + epoch)
    snapshots to ``<ckpt_path>.last`` every ``snapshot_every`` epochs;
    ``resume=True`` continues from it."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training over a mesh is not ported yet "
            "(ROADMAP.md, Queue 1 M15)")
    device = torch.device(device)
    # live (non-pad) edges per epoch, for the per-epoch edges/s counter
    epoch_edges = int(sum(
        (np.asarray(b.edge_type) != PAD_EDGE_TYPE).sum()
        for b in train_batches))

    # move the batches to the device ONCE (one stacked copy); the epoch
    # loops over resident batches, whose index streams
    # (models/shmp_gnn.batch_typed_streams) are derived at first use
    def to_device_list(batches):
        stacked = stack_batches(batches).to(device, training=True)
        return [stacked[i] for i in range(len(batches))]

    train_dev = to_device_list(train_batches)
    val_dev = to_device_list(val_batches) if val_batches else None
    n_train = len(train_dev)

    def val_loss() -> float:
        if val_dev is None:
            return float("nan")
        with torch.no_grad():
            s_sum = torch.zeros((), device=device)
            w_sum = torch.zeros((), device=device)
            for b in val_dev:
                s_, w_ = eval_fn(params, b)
                s_sum += s_
                w_sum += w_
        return float(s_sum) / max(float(w_sum), 1.0)

    sched = ReduceLROnPlateau(lr=lr, factor=factor, patience=patience,
                              min_lr=min_lr)
    generator = torch.Generator(device=device)
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
        generator.manual_seed(_epoch_seed(seed, epoch))
        order = rng_np.permutation(n_train)
        loss_sum = torch.zeros((), device=device)
        n_bad = torch.zeros((), dtype=torch.int64, device=device)
        for bi in order:
            loss, ok = train_step(params, opt, loss_fn, train_dev[int(bi)],
                                  sched.lr, generator)
            loss_sum += torch.where(ok, loss, torch.zeros_like(loss))
            n_bad += (~ok).long()
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
                    save_checkpoint(
                        ckpt_path + ".best", best_params,
                        config=ckpt_config,
                        extra={"epoch": epoch, "val_loss": best_val})
        if log_every and (epoch % log_every == 0 or epoch == epochs - 1):
            log_fn(f"epoch {epoch:4d} train {tl:.5f} val {vl:.5f} "
                   f"lr {sched.lr:.2e} {times[-1]:.2f}s "
                   f"{epoch_edges / max(t_train, 1e-9) / 1e6:.1f}M edges/s")
        if ckpt_path and snapshot_every and (
                epoch % snapshot_every == 0 or epoch == epochs - 1):
            save_checkpoint(
                ckpt_path + ".last", params, config=ckpt_config,
                opt_state=opt.state_arrays(),
                extra={"epoch": epoch, "lr": sched.lr,
                       "best": sched.best, "num_bad": sched.num_bad,
                       "best_val": best_val})
    return TrainResult(params, best_params, train_losses, val_losses,
                       best_val, times, train_times)


# ----------------------------------------------------------- neighborhood
def neighborhood_loss_fn(tgt_cfg, qry_cfg, query_batch):
    def f(params, batch, generator):
        return neigh_mod.train_loss(params, tgt_cfg, qry_cfg, batch,
                                    query_batch, generator=generator)

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
    ``tgt_cfg``)."""
    device = resolve_device(device)
    params = params.to(device)
    qb = query_batch.to(device)
    return run_training(
        params=params, opt=make_adam(params, weight_decay),
        train_batches=train_batches, val_batches=val_batches,
        loss_fn=neighborhood_loss_fn(tgt_cfg, qry_cfg, qb),
        eval_fn=neighborhood_eval_fn(eval_tgt_cfg or tgt_cfg, qry_cfg, qb),
        epochs=epochs, lr=lr, ckpt_path=ckpt_path,
        ckpt_config=ckpt_config, mesh=mesh, device=device, **kw)


# ---------------------------------------------------------------- gossip
def gossip_loss_fn(dropout: float, query_embs: torch.Tensor):
    def f(params, batch, generator):
        return gossip_mod.gossip_loss(params, batch, query_embs, dropout,
                                      True, generator)

    return f


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
    as in ``train_neighborhood``)."""
    device = resolve_device(device)
    params = params.to(device)
    query_embs = query_embs.detach().to(device)
    return run_training(
        params=params, opt=make_adam(params, weight_decay),
        train_batches=train_batches, val_batches=val_batches,
        loss_fn=gossip_loss_fn(dropout, query_embs),
        eval_fn=gossip_eval_fn(query_embs),
        epochs=epochs, lr=lr, ckpt_path=ckpt_path,
        ckpt_config=ckpt_config, mesh=mesh, device=device, **kw)


# ------------------------------------------------------------- prediction
def _valid_rows(batches: List[PackedGraphs], preds: torch.Tensor,
                mask_field: str) -> np.ndarray:
    all_preds = preds.cpu().numpy()
    out = [p[np.asarray(getattr(b, mask_field)) > 0]
           for b, p in zip(batches, all_preds)]
    return np.concatenate(out, axis=0)


def predict_neighborhood_counts(params, tgt_cfg, query_embs: torch.Tensor,
                                batches: List[PackedGraphs],
                                device) -> np.ndarray:
    """(#valid graphs over all batches, Q) de-logged stage-1 counts.
    ``query_embs`` ([Q, H] on ``device``, ``embed_queries``) come from the
    query tower, which a service runs once: the query set is static."""
    with torch.inference_mode():
        stacked = stack_batches(batches).to(device)
        preds = torch.stack([
            neigh_mod.predict_counts_from_embs(params, tgt_cfg,
                                               stacked[bi], query_embs)
            for bi in range(len(batches))])  # [B, g_cap, Q]
        return _valid_rows(batches, preds, "graph_mask")


def predict_gossip_counts(params, query_embs: torch.Tensor,
                          batches: List[PackedGraphs],
                          device) -> np.ndarray:
    """(#total_nodes, Q) refined per-node counts in node order."""
    with torch.inference_mode():
        stacked = stack_batches(batches).to(device)
        preds = torch.stack([
            gossip_mod.gossip_predict(params, stacked[bi], query_embs)
            for bi in range(len(batches))])  # [B, n_cap, Q]
        return _valid_rows(batches, preds, "node_mask")
