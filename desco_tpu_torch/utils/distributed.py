"""Processes as replicas: the port's counterpart of desco_tpu's ``data``
mesh axis across processes (desco_tpu/parallel/topology.py:55-64, where
``create_hybrid_device_mesh`` puts the ``data`` axis over processes and
keeps the ``graph`` axis inside each).

Each rank of a ``torch.distributed`` process group holds a contiguous
block of the data replicas on its own card (parallel/dp.make_mesh,
parallel/topology.make_mesh2d). The group starts from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) or from an explicit ``init_method`` (a ``file://`` path,
as the tests give), always with an explicit timeout.

The backend is chosen once, by rule, and printed: ``nccl`` where every
rank of the host owns a card of its own, ``gloo`` where ranks share a
card or run on the CPU. Nothing switches backend after a failure: a
failed init or collective raises. Under gloo a card's tensor is staged
through host memory by this module (a copy out, the gather on the host,
a copy back), so the collective never depends on gloo's CUDA support.

Reductions are never ``all_reduce``, whose order of addition is the
backend's: ``gather_in_rank_order`` gathers every replica's terms, and
the caller adds them in replica order, so every rank holds the bits one
process would.

A halo graph axis across ranks (parallel/halo.py: a shard list some of
whose slots other ranks hold) exchanges rows with ``exchange_blocks``,
desco_tpu's ``all_to_all``: block j of every rank goes to rank j, in one
``all_to_all_single`` per exchange site, inside the process group of the
ranks the shards span (``group_of``), with only the blocks each rank
needs. It is differentiable: its backward is the same exchange of the
cotangents.

The gather and the exchange are the split points of a compiled step
(utils/cuda_graphs.collective): inside a step captured as a chain of
CUDA graphs they write static receive buffers between the pieces'
replays, and any other collective there raises. Under gloo a card's
tensor is staged through reused host buffers, pinned.

With no group, ``rank()`` is 0 and ``world()`` 1, and the gather returns
its input: the single-process paths run through the same code.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import os
from typing import Optional

import torch
import torch.distributed as dist

from .cuda_graphs import collective, unrecorded_collective

# long enough for rank 0 to compute a training set's ground truth while
# the other ranks wait (``rank_zero_first``)
DEFAULT_TIMEOUT_S = 1800.0


def choose_backend(device_type: str, local_world: int, n_cards: int) -> str:
    """``nccl`` where every one of the host's ``local_world`` ranks owns a
    card of its own, ``gloo`` where they share a card or run on the CPU."""
    if device_type == "cuda" and 0 < local_world <= n_cards:
        return "nccl"
    return "gloo"


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def launched_world() -> int:
    """The group size torchrun's environment asks for (1 without it)."""
    return _env_int("WORLD_SIZE", 1)


def init(device=None, *, init_method: Optional[str] = None,
         rank: Optional[int] = None, world_size: Optional[int] = None,
         timeout_s: float = DEFAULT_TIMEOUT_S, log_fn=print) -> str:
    """Start the process group and return its backend. Without
    ``init_method`` the rank, world size and rendezvous come from
    torchrun's environment (``env://``). ``device`` is the device type
    the ranks compute on (None means CUDA); on CUDA the rank's card
    (``rank_device``) becomes the current device."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already started")
    if init_method is None:
        init_method = "env://"
        rank = _env_int("RANK", rank)
        world_size = _env_int("WORLD_SIZE", world_size)
    if rank is None or world_size is None:
        raise ValueError("a process group needs its rank and world size")
    dev_type = torch.device("cuda" if device is None else device).type
    local_world = _env_int("LOCAL_WORLD_SIZE", world_size)
    n_cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    if dev_type == "cuda":
        if not n_cards:
            raise RuntimeError("no CUDA device is visible for the ranks; "
                               "pass device='cpu' to run them on the CPU")
        torch.cuda.set_device(rank_device("cuda", rank))
    backend = choose_backend(dev_type, local_world, n_cards)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    why = ("every rank owns a card" if backend == "nccl"
           else "the CPU" if dev_type == "cpu"
           else f"{local_world} ranks share {n_cards} card(s)")
    log_fn(f"process group: rank {rank} of {world_size}, backend "
           f"{backend} ({why}), device {rank_device(dev_type, rank)}")
    return backend


def shutdown() -> None:
    """End the process group, if one was started."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUPS.clear()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def rank_device(device=None, rank_: Optional[int] = None) -> torch.device:
    """The rank's device: ``cuda:(LOCAL_RANK % device_count)`` for a CUDA
    ``device`` (None means CUDA), the CPU for a CPU one. ``LOCAL_RANK``
    defaults to the rank (``rank_``, else the group's)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    local = _env_int("LOCAL_RANK", rank() if rank_ is None else rank_)
    return torch.device("cuda", local % torch.cuda.device_count())


def barrier() -> None:
    unrecorded_collective("a barrier")
    if world() > 1:
        dist.barrier()


@contextlib.contextmanager
def rank_zero_first():
    """Rank 0 runs the block first (it fills the disk caches the block
    reads), the other ranks after it: they then find the caches
    written."""
    if rank() != 0:
        barrier()
    yield
    if rank() == 0:
        barrier()


# reused pinned host buffers of the gloo staging copies, per (side,
# dtype): a collective's copies block, so one pair serves them all
_STAGING: dict = {}


def _staging(side: str, like: torch.Tensor) -> torch.Tensor:
    """A pinned host tensor shaped as ``like`` (a card's tensor) for a
    collective's staging copy (``side`` "in" or "out"), on a reused
    buffer."""
    key = (side, like.dtype)
    buf = _STAGING.get(key)
    if buf is None or buf.numel() < like.numel():
        buf = torch.empty(max(like.numel(), 1), dtype=like.dtype,
                          pin_memory=True)
        _STAGING[key] = buf
    return buf[:like.numel()].view(like.shape)


def _all_gather_into(t: torch.Tensor, out: torch.Tensor) -> None:
    """Every rank's ``t`` (same shape everywhere) into ``out`` [world,
    ...], in rank order. Under gloo a card's tensor goes through host
    memory."""
    if backend() == "nccl":
        dist.all_gather_into_tensor(out, t.contiguous())
        return
    host = t.contiguous()
    if t.is_cuda:
        host = _staging("in", t)
        host.copy_(t)
    parts = _staging("out", out) if out.is_cuda else out
    dist.all_gather(list(parts.unbind(0)), host)
    if parts is not out:
        out.copy_(parts)


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order [world, ...], on ``t``'s
    device; not a split point."""
    unrecorded_collective("a gather")
    out = t.new_empty((world(),) + tuple(t.shape))
    _all_gather_into(t.detach(), out)
    return out


def gather_in_rank_order(local: torch.Tensor, device=None) -> torch.Tensor:
    """``local``: one row per replica this rank holds ([L, ...], every rank
    the same L). Returns the rows of every rank's replicas [world * L,
    ...], in global replica order (rank r's replicas are the block
    [r L, (r + 1) L)), on ``device`` (default ``local``'s). With no group
    it is ``local`` itself, moved. A split point of a compiled step."""
    dev = torch.device(device) if device is not None else local.device
    if world() == 1:
        return local.to(dev)
    if backend() != "nccl" and dev.type == "cpu":
        local = local.to("cpu")  # one copy out, no copy back
    out = collective(("gather", _members(None), None), local.detach(),
                     (world(),) + tuple(local.shape), _all_gather_into)
    return out.reshape((-1,) + tuple(local.shape[1:])).to(dev)


def group_of(ranks, make: bool = False) -> Optional[object]:
    """The process group of ``ranks`` (sorted ranks of the default
    group): None, the default group itself, where they are every rank;
    else the group ``make=True`` made for them. ``new_group`` is a
    collective of every rank, so every rank makes the groups, the same
    ones in the same order (``topology.make_mesh2d`` makes its rows'),
    members or not; without ``make`` a group not made yet raises."""
    ranks = tuple(ranks)
    if ranks == tuple(range(world())):
        return None
    if ranks not in _GROUPS:
        if not make:
            raise ValueError(f"no process group of ranks {ranks} was made "
                             f"on every rank (distributed.group_of(ranks, "
                             f"make=True) does)")
        unrecorded_collective("a process group's creation")
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


_GROUPS: dict = {}


def _members(group) -> tuple:
    """The ranks of ``group`` (None: every rank), sorted."""
    if group is None:
        return tuple(range(world()))
    for ranks, made in _GROUPS.items():
        if made is group:
            return ranks
    return tuple(sorted(dist.get_process_group_ranks(group)))


def _all_to_all_into(src: torch.Tensor, out: torch.Tensor, group, n_in,
                     n_out) -> None:
    """``n_in[j]`` rows of ``src`` (in rank order) to rank j of ``group``;
    ``out`` receives ``n_out[p]`` rows from rank p, in rank order. Under
    gloo a card's tensor goes through host memory."""
    staged = backend() != "nccl" and src.is_cuda
    host_in, host_out = src.contiguous(), out
    if staged:
        host_in, host_out = _staging("in", src), _staging("out", out)
        host_in.copy_(src)
    dist.all_to_all_single(host_out, host_in, output_split_sizes=list(n_out),
                           input_split_sizes=list(n_in), group=group)
    if staged:
        out.copy_(host_out)


def _all_to_all(t: torch.Tensor, group, n_in, n_out) -> torch.Tensor:
    """The all-to-all of ``exchange_blocks`` on ``t``'s device: a split
    point of a compiled step."""
    return collective(
        ("all_to_all", _members(group), (n_in, n_out)), t.detach(),
        (sum(n_out),) + tuple(t.shape[1:]),
        lambda src, out: _all_to_all_into(src, out, group, n_in, n_out))


class _Exchange(torch.autograd.Function):
    """``exchange_blocks`` inside autograd: the transpose of an all-to-all
    is the all-to-all with the counts swapped, so the backward exchanges
    the cotangents. The anchors only decide whether the node is
    recorded."""

    @staticmethod
    def forward(ctx, send, group, n_in, n_out, *anchors):
        ctx.group, ctx.counts, ctx.n_anchors = group, (n_in, n_out), \
            len(anchors)
        return _all_to_all(send, group, n_in, n_out)

    @staticmethod
    def backward(ctx, grad):
        n_in, n_out = ctx.counts
        return ((_all_to_all(grad, ctx.group, n_out, n_in), None, None,
                 None) + (None,) * ctx.n_anchors)


def exchange_blocks(send: torch.Tensor, group=None, anchors=(),
                    counts=None) -> torch.Tensor:
    """desco_tpu's ``all_to_all``: ``send`` [W, ...] (W the size of
    ``group``, None the default one) on this rank's device; block j goes
    to rank j, and block p of the result [W, ...] is the block rank p
    sent here. Every rank of the group calls it, with the same shape.
    With one rank it is ``send`` itself.

    ``counts`` (n_in, n_out), one entry per rank of the group: ``send``
    holds n_in[j] blocks for rank j, in rank order, and the result
    n_out[p] blocks from rank p (what rank p's n_in gives this rank), so
    that only the blocks a rank needs are sent; 0 for this rank leaves
    its own blocks out.

    Differentiable. Every rank must record it in autograd alike, or one
    rank's backward would wait for a collective the others never issue:
    the node is recorded where ``send`` or one of ``anchors`` (tensors
    that require grad on every rank alike, such as the layer's inputs)
    requires grad, even where this rank's blocks hold nothing that does
    (a shard with no rows to send)."""
    size = dist.get_world_size(group) if dist.is_initialized() else 1
    if counts is None:
        if send.shape[0] != size:
            raise ValueError(f"exchange_blocks takes one block per rank: "
                             f"{send.shape[0]} blocks for {size} ranks")
        counts = ([1] * size, [1] * size)
    n_in, n_out = (tuple(int(c) for c in cs) for cs in counts)
    if len(n_in) != size or len(n_out) != size or sum(n_in) != send.shape[0]:
        raise ValueError(f"exchange_blocks: counts {n_in} / {n_out} for "
                         f"{size} ranks and {send.shape[0]} blocks")
    if size == 1:
        return send
    return _Exchange.apply(send, group, n_in, n_out, *anchors)


def check_sequence(keys: list) -> None:
    """Raise unless every rank of each process group that a compiled
    step's split points (``keys``, utils/cuda_graphs.GraphedStep
    .sequence) run in issues the same collectives there, in the same
    order, with blocks of the same shape and dtype: per group, in the
    order of their ranks, the members' lists gathered within it."""
    if world() == 1:
        return
    mine: dict = {}
    for kind, members, _, shape, dtype, _ in keys:
        mine.setdefault(members, []).append((kind, shape[1:], dtype))
    for members in sorted(mine):
        got = [None] * len(members)
        dist.all_gather_object(got, mine[members], group=group_of(members))
        differ = [q for q, g in zip(members, got) if g != mine[members]]
        if differ:
            raise RuntimeError(
                f"the collectives of a compiled step differ between the "
                f"ranks of group {members}: ranks {differ} against rank "
                f"{rank()}")


def check_replicated(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` has the same bits on every rank (a digest of
    each rank's copy, gathered). One read-back."""
    unrecorded_collective("the check that every rank holds the same "
                          f"{what}")
    if world() == 1:
        return
    digest = hashlib.sha256(
        t.detach().to("cpu").contiguous().numpy().tobytes()).digest()
    mine = torch.frombuffer(bytearray(digest), dtype=torch.uint8)
    if backend() == "nccl":
        mine = mine.to(rank_device("cuda"))
    every = _all_gather(mine).cpu()
    differ = [r for r in range(world()) if not torch.equal(every[r],
                                                           every[0])]
    if differ:
        raise RuntimeError(f"the {what} differ between ranks: ranks "
                           f"{differ} against rank 0")
