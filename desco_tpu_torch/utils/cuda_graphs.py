"""Compiled steps and forwards as CUDA graphs: the port's counterparts of
desco_tpu's ``jax.jit(carried_step, donate_argnums=0)`` and ``eval_jit``
(desco_tpu/train/loop.py:148-166), and of its ``_jit_*`` caches of
serving forwards (``_jit_predict_from_embs``, ``_jit_gossip_predict``,
loop.py:355-475; the bounds' ``_batch_bounds``, truth/bounds.py:94; the
DP predicts, parallel/dp.py:115, 173; the halo serve's ``run_one``,
parallel/halo.py:1032).

desco_tpu compiles each step once per shape and feeds it one resident
batch after another. Here a step is captured once per run and shape as a
``torch.cuda.CUDAGraph`` and replayed per batch (``GraphedStep``):

  * the step reads one set of static buffers (``static_like``): every
    field of a batch of the run's shape and the per-batch state the
    towers derive (the ``TypedStreams`` and the pooling offsets,
    models/shmp_gnn.prepare_batch), which every resident batch has
    derived before the first step; a step copies its batch into them,
    device to device (``copy_into``), then replays;
  * what the step updates in place (the parameters, Adam's moments and
    count, the epoch's device accumulators) keeps its address, so the
    graph updates the live tensors; the learning rate is a device scalar
    the plateau schedule writes with ``fill_`` (desco_tpu's ``lr_dev``);
  * before the capture the step runs a few times on a side stream (lazy
    set-up: kernel libraries, their shared-memory attributes, cuBLAS
    handles), then those tensors get back the values they had, so the
    warm-up changes nothing a run can see;
  * a replay launches the kernels and runs no Python wrapper, so the
    launch counters (ops/cuda_segment.LaunchRecord) add, per replay, what
    the wrappers counted while the capture recorded; the warm-up's
    launches are taken back out, and a run counts what an eager one would;
  * a step that draws from generators (dropout above 0; one per DP
    replica or halo shard) needs each registered with the graph, where
    the card's PyTorch has ``CUDAGraph.register_generator_state``; without
    it the capture raises. A generator is reseeded (``manual_seed``)
    between replays, never made anew, so the graph keeps reading it;
  * a data-parallel step takes a group of D batches: the static buffers
    hold the group (a list); a halo step (``placed_step_fn``) reads the
    shards, which stay on the device for the run, and copies only the
    query embeddings and the learning rate into its buffers;
  * a capture runs with the cyclic garbage collector paused
    (``no_collection``): a collection inside it that destroys an earlier
    step's graphs frees device memory and invalidates the capture;
  * a step that reaches collectives (across the ranks of a process
    group: a data-parallel step's gather, a halo step's exchanges and
    their backward) is a chain of graphs split at them: each piece
    between two collectives is captured once, every call replays the
    pieces in capture order, and between two pieces the one collective
    at that point runs eagerly (``collective``), reading the static
    tensor the piece before wrote and writing the static buffer the
    piece after reads. The first call records the collectives (kind,
    group, counts, shapes); every later one must issue the same, and
    every rank of a group the same there (``distributed
    .check_sequence``); a collective that is not a split point raises
    inside a piece. In one process a step reaches none and is one graph.

A forward is the same capture with ``inference=True``: its buffers are
made, its warm-up and capture run, and every call runs, under
``torch.inference_mode()``; a call returns the forward's static outputs,
which the next replay overwrites, so a caller that keeps them clones
them. ``ForwardCache`` keys forwards as ``jax.jit`` keys its cache: every
input tensor's shape, dtype and device, plus the static arguments the
caller names (a config, the query count, the bounds' schedules); a
forward whose ``group`` (a serving bucket on one device) is captured at
new shapes drops the one it replaces. The forwards of one owner (a
service, a run) share one memory pool per device (``GraphPool``): they
replay one at a time, and each keeps its static inputs and outputs
alive, so one graph's scratch memory may serve the next.

A failed capture or replay raises; nothing falls back to the eager step
or forward. On the CPU, which only the tests ask for, the same
static-buffer step or forward runs without a capture, through the same
split points (static receive buffers, the sequence recorded and
checked). ``no_sync`` runs
the graphed loop under ``torch.cuda.set_sync_debug_mode("error")``, so a
read-back left in a step raises instead of stalling the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from typing import Callable, Optional, Sequence

import torch

from ..ops import cuda_segment as cs
from . import trace

WARMUP_STEPS = 3
# a forward's lazy set-up (kernel libraries and their shared-memory
# attributes, the towers' bias ids, cuBLAS handles) needs one call; the
# second checks that the first left nothing to set up (so does a step
# split at collectives, whose eager calls cost the collectives too)
WARMUP_FORWARDS = 2


def _derived(value) -> list:
    """The names of the state derived onto a dataclass instance beyond its
    fields (a batch's streams and pooling offsets,
    models/shmp_gnn.batch_typed_streams / batch_pool_offsets)."""
    fields = {f.name for f in dataclasses.fields(value)}
    return sorted(n for n, v in getattr(value, "__dict__", {}).items()
                  if n not in fields and v is not None)


def static_like(value):
    """A copy of ``value`` (a batch, its streams, a tensor, a list or
    tuple of them) with fresh tensors of the same shapes: the static
    buffers of a captured step. A batch's derived state comes along."""
    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, (list, tuple)):
        return type(value)(static_like(v) for v in value)
    if dataclasses.is_dataclass(value):
        out = dataclasses.replace(value, **{
            f.name: static_like(getattr(value, f.name))
            for f in dataclasses.fields(value)})
        for name in _derived(value):
            setattr(out, name, static_like(getattr(value, name)))
        return out
    return value


def _nbytes(value) -> int:
    """The bytes of every tensor in ``value`` (walked as ``static_like``
    walks it): what ``copy_into`` copies into it."""
    if isinstance(value, torch.Tensor):
        return value.nbytes
    if isinstance(value, (list, tuple)):
        return sum(_nbytes(v) for v in value)
    if dataclasses.is_dataclass(value):
        return (sum(_nbytes(getattr(value, f.name))
                    for f in dataclasses.fields(value))
                + sum(_nbytes(getattr(value, n)) for n in _derived(value)))
    return 0


def copy_into(dst, src) -> None:
    """Copy ``src`` into the static buffers ``dst`` (``static_like`` of a
    batch of the same shape), derived state included. Raises where the
    two differ in shape or in what they carry."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape:
            raise ValueError(f"a captured step takes batches of one shape: "
                             f"{tuple(dst.shape)} against "
                             f"{getattr(src, 'shape', src)}")
        dst.copy_(src)
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError(f"a captured step takes groups of {len(dst)}, "
                             f"got {len(src)}")
        for d, s in zip(dst, src):
            copy_into(d, s)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            copy_into(getattr(dst, f.name), getattr(src, f.name))
        missing = [n for n in _derived(dst) if getattr(src, n, None) is None]
        if missing:
            raise ValueError(f"the batch has no {', '.join(missing)}: "
                             f"derive it before the loop (prepare_batch)")
        for name in _derived(dst):
            copy_into(getattr(dst, name), getattr(src, name))
    elif dst != src:
        raise ValueError(f"a captured step takes batches of one shape: "
                         f"{dst} against {src}")


@contextlib.contextmanager
def no_sync(device):
    """On a CUDA device, raise on any synchronizing call inside (a
    read-back, a blocking copy): a graphed loop has none. PyTorch calls
    this debug mode a prototype that does not see every synchronizing
    operation; tests/test_torch_graphed_step.py also runs a static step
    with the read-backs themselves made to raise."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def no_collection():
    """No cyclic garbage collection inside, where a capture runs: one that
    destroys an earlier step's graphs (a step held in a reference cycle)
    frees device memory, which invalidates the capture.
    ``torch.cuda.graph`` collects once before it begins."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _device_of(value) -> torch.device:
    """The device of the first tensor in ``value`` (as ``static_like``
    walks it)."""
    if isinstance(value, torch.Tensor):
        return value.device
    if isinstance(value, (list, tuple)):
        return _device_of(value[0])
    return _device_of(getattr(value, dataclasses.fields(value)[0].name))


# ------------------------------------------------------ the chain's splits
class _Chain:
    """One run of a step's function through its split points: ``mode``
    "run" (the collectives run: the warm-up, the CPU) or "capture" (each
    split point ends a piece's capture and begins the next); ``index``
    counts the split points passed, ``keys`` records them at the first
    call, ``inside`` is set while a split point's collective runs."""

    def __init__(self, step, mode: str):
        self.step, self.mode = step, mode
        self.index, self.keys, self.inside = 0, [], False


# the chain whose function is running (one at a time: the backward's
# split points run on autograd's device thread while the caller waits)
_ACTIVE: Optional[_Chain] = None


def collective(key: tuple, src: torch.Tensor, out_shape,
               run: Callable) -> torch.Tensor:
    """A collective at a split point: ``run(src, out)`` writes into
    ``out`` (``out_shape``, ``src``'s dtype and device) what the
    collective gives for ``src``; returns ``out``. Outside a chained step
    it runs on a new ``out``. Inside one (a ``GraphedStep`` whose
    function reaches it) it is one of the step's split points: ``key``
    (kind, group, counts) and the shapes must be those of the same point
    at the step's first call, which made ``out``; every later call
    writes that buffer. A capture ends one piece there and begins the
    next, and the collective runs between their replays."""
    chain = _ACTIVE
    out_shape = tuple(int(n) for n in out_shape)
    if chain is None:
        out = src.new_empty(out_shape)
        run(src, out)
        return out
    return chain.step._split(chain, tuple(key) + (
        tuple(src.shape), str(src.dtype), out_shape), src, run)


def unrecorded_collective(what: str) -> None:
    """Raise inside a chained step's piece: a collective that is not a
    split point (``collective``) would run once at the capture and never
    at a replay."""
    chain = _ACTIVE
    if chain is not None and not chain.inside:
        raise RuntimeError(
            f"{what} reached inside a chained step's piece ({chain.mode}): "
            f"only its split points (distributed.exchange_blocks, "
            f"gather_in_rank_order) may run a collective there")


def _pool_bytes(ids: set) -> Optional[int]:
    """The bytes the memory pools ``ids`` hold on the card (the caching
    allocator's snapshot); None where this PyTorch's snapshot does not
    name segments' pools."""
    total, named = 0, False
    for seg in torch.cuda.memory_snapshot() if ids else ():
        pool = seg.get("segment_pool_id")
        if pool is None:
            continue
        named = True
        if tuple(pool) in ids:
            total += int(seg["total_size"])
    return total if named or not ids else None


class GraphedStep:
    """``fn(batch)`` over same-shape batches, on static buffers made from
    ``example``; ``capture`` (a CUDA device) records it once as a CUDA
    graph, in ``pool`` where given, and every call replays it and returns
    what ``fn`` returned at the capture (its static outputs). A train step
    returns nothing: it updates ``state`` (tensors) in place, which the
    warm-up before the capture leaves as it found them, and may draw from
    ``generators``. ``inference``: ``fn`` is a forward, made and run under
    inference mode. ``fn`` reads nothing that changes between calls but
    its batch; data it closes over (parameters, a partition's shards)
    must keep their storage. An empty ``example`` needs the ``device``.

    Where ``fn`` reaches collectives (``collective``: across ranks), the
    step is a chain of graphs split at them (``graphs``, one more than
    the split points), in a memory pool of its own (``pool`` must be
    None), captured in the relaxed mode: a split point in the backward
    ends and begins captures on autograd's device thread. ``sequence``:
    the split points' keys, recorded at the first call (on the card the
    first warm-up); later calls, the capture included, must match them.

    Spans (utils/trace.py): ``graph.capture`` around the warm-up and
    capture; per call ``step.copy_in`` (the batch into the static
    buffers), ``step.replay`` (each graph's launch; on the CPU the
    static-buffer run) and ``step.collective`` (each split point's
    collective, after the host has waited for the piece before; its
    ``info["step"]`` is the step's ``id``). Counters: ``replays`` (calls) and ``copy_in_bytes``."""

    def __init__(self, fn: Callable, example, *, capture: bool,
                 state: Sequence[torch.Tensor] = (),
                 generators: Sequence[torch.Generator] = (),
                 pool=None, inference: bool = False, device=None):
        self.fn = fn
        self.inference = inference
        with self._mode():
            self.batch = static_like(example)
        self.graphs: list = []
        self.sequence: Optional[list] = None
        self.buffers: list = []   # per split point: its static output
        self.splits: list = []    # per split point: (run, static input)
        self.outputs = None
        self.record = cs.LaunchRecord()
        self.capture_s = 0.0
        self.batch_bytes = _nbytes(self.batch)
        self.device = None
        self._pool = self._drawn = self._capture_mode = None
        if capture:
            self._capture(list(state), list(generators), pool, torch.device(
                device if device is not None else _device_of(self.batch)))

    def _mode(self):
        return (torch.inference_mode() if self.inference
                else contextlib.nullcontext())

    def _run(self, mode: str):
        """``fn`` on the static buffers through its split points; the first
        run records them and checks them across the ranks."""
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a chained step runs inside another")
        chain = _ACTIVE = _Chain(self, mode)
        try:
            out = self.fn(self.batch)
        finally:
            _ACTIVE = None
        if self.sequence is None:
            self.sequence = chain.keys
            if self.sequence:
                from .distributed import check_sequence
                check_sequence(self.sequence)
        elif chain.index != len(self.sequence):
            raise RuntimeError(
                f"this call issued {chain.index} collectives, the first "
                f"{len(self.sequence)}: a chained step issues the same in "
                f"every call")
        return out

    def _split(self, chain: _Chain, key: tuple, src: torch.Tensor,
               run: Callable) -> torch.Tensor:
        i = chain.index
        chain.index += 1
        if self.sequence is None:
            chain.keys.append(key)
            self.buffers.append(src.new_empty(key[-1]))
        elif i >= len(self.sequence) or self.sequence[i] != key:
            first = self.sequence[i] if i < len(self.sequence) else None
            raise RuntimeError(
                f"collective {i} of this call is {key}, the first call's "
                f"{first}: a chained step issues the same collectives, "
                f"with the same shapes and groups, in every call")
        out = self.buffers[i]
        if chain.mode == "capture":
            self.splits.append((run, src))
            self.graphs[-1].capture_end()
            self._begin_piece()
        else:
            chain.inside = True
            try:
                with trace.span("step.collective", step=id(self)):
                    run(src, out)
            finally:
                chain.inside = False
        return out

    def _begin_piece(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen in self._drawn:
            graph.register_generator_state(gen)
        graph.capture_begin(pool=self._pool,
                            capture_error_mode=self._capture_mode)
        self.graphs.append(graph)

    def _capture(self, state, generators, pool, dev) -> None:
        with trace.span("graph.capture"):
            t0 = time.perf_counter()
            counted = cs.read_launches()
            saved = [t.clone() for t in state]
            gen_states = [g.get_state() for g in generators]
            self.device = dev
            with torch.cuda.device(dev), self._mode():
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    self._run("run")
                    # a chain's second run checks that the first left nothing
                    # to set up, as a forward's does
                    for _ in range((WARMUP_FORWARDS
                                    if self.inference or self.sequence
                                    else WARMUP_STEPS) - 1):
                        self._run("run")
                torch.cuda.current_stream(dev).wait_stream(side)
                for t, s in zip(state, saved):
                    t.copy_(s)
                self._drawn = []
                for gen, gen_state in zip(generators, gen_states):
                    draws = not torch.equal(gen.get_state(), gen_state)
                    gen.set_state(gen_state)
                    if draws:
                        if not hasattr(torch.cuda.CUDAGraph,
                                       "register_generator_state"):
                            raise RuntimeError(
                                "the step draws from a generator (dropout "
                                "above 0) and this PyTorch cannot register a "
                                "generator with a CUDA graph: train eagerly "
                                "(graphed=False)")
                        self._drawn.append(gen)
                if self.sequence and pool is not None:
                    raise ValueError("a step split at collectives captures "
                                     "into a memory pool of its own")
                # a chain's pieces share a pool of their own
                self._pool = (torch.cuda.graph_pool_handle()
                              if self.sequence else pool)
                self._capture_mode = "relaxed" if self.sequence else "global"
                # as torch.cuda.graph begins a capture
                with self.record.capture(), no_collection():
                    torch.cuda.synchronize()
                    gc.collect()
                    torch.cuda.empty_cache()
                    with torch.cuda.stream(side):
                        self._begin_piece()
                        try:
                            self.outputs = self._run("capture")
                        except BaseException:
                            with contextlib.suppress(Exception):
                                self.graphs[-1].capture_end()
                            self.graphs = []
                            raise
                        self.graphs[-1].capture_end()
            cs.reset_launches()
            cs.add_launches(counted)
            self.capture_s = time.perf_counter() - t0

    def pool_bytes(self) -> Optional[int]:
        """The bytes the step's memory pool holds on the card (None where
        not reported; 0 without a capture)."""
        if not self.graphs:
            return 0
        return _pool_bytes({tuple(self._pool if self._pool is not None
                                  else self.graphs[0].pool())})

    def __call__(self, batch):
        trace.add("replays", 1)
        trace.add("copy_in_bytes", self.batch_bytes)
        with self._mode():
            with trace.span("step.copy_in"):
                copy_into(self.batch, batch)
            if not self.graphs:
                with trace.span("step.replay"):
                    return self._run("run")
            with trace.span("step.replay"):
                self.graphs[0].replay()
            if self.splits:
                stream = torch.cuda.current_stream(self.device)
                for (run, src), out, graph in zip(
                        self.splits, self.buffers, self.graphs[1:]):
                    stream.synchronize()
                    with trace.span("step.collective", step=id(self)):
                        run(src, out)
                    with trace.span("step.replay"):
                        graph.replay()
            self.record.replayed()
            return self.outputs


def placed_step_fn(body: Callable, reseed: Callable, opt, *,
                   graphed: bool, exchange: Callable, finish: Callable,
                   prepare: Optional[Callable] = None) -> Callable:
    """A train step over data placed on the device for a run (a halo
    partition's shards, a DP x halo grid's replicas): ``step(params,
    place, query_embs, lr, seed=0) -> (loss, ok)`` calls
    ``prepare(place)`` (the one-time checks and the set-up that issues
    collectives: never inside a capture), ``reseed(place, seed)``, which
    reseeds the step's generators (made once) and returns them, then
    ``body(params, place, query_embs) -> terms``, ``exchange(terms)``
    (every slot's rows: across ranks the gather) and ``finish(terms, lr)
    -> (loss, ok)``, which updates ``opt`` (train/loop.Adam) in place.

    ``graphed``: the step runs as a ``GraphedStep`` made at the first call
    for that call's ``params`` and ``place``, which later calls must pass
    again; the query embeddings and the learning rate (a float is filled
    into a device scalar) are its static buffers, and the loss and flag
    come back as copies of its outputs. It is captured where ``place``
    lies on one CUDA device, a chain of graphs split at its collectives
    where ``place`` spans ranks, and raises where it spans several
    devices; on the CPU it runs without a capture."""

    def eager(params, place, query_embs, lr, seed=0):
        if prepare is not None:
            prepare(place)
        reseed(place, seed)
        return finish(exchange(body(params, place, query_embs)), lr)

    if not graphed:
        return eager

    held = {}

    def step(params, place, query_embs, lr, seed=0):
        if held and (params is not held["params"]
                     or place is not held["place"]):
            raise ValueError("a graphed step replays over the parameters "
                             "and data of its first call")
        dev = query_embs.device
        if not held:
            devices = {t.device for t in _tensors(place)}
            if dev.type == "cuda" and devices != {dev}:
                raise ValueError(f"a captured step runs on one card; its "
                                 f"data lies on {sorted(map(str, devices))}")
            if prepare is not None:
                prepare(place)
        gens = reseed(place, seed)
        if not isinstance(lr, torch.Tensor):
            lr = torch.full((), float(lr), device=dev)
        if not held:
            held.update(params=params, place=place, step=GraphedStep(
                lambda b: finish(exchange(body(params, place, b[0])), b[1]),
                (query_embs, lr), capture=dev.type == "cuda",
                state=opt.state_tensors(), generators=gens))
        loss, ok = held["step"]((query_embs, lr))
        return loss.clone(), ok.clone()

    step.held = held
    return step


def _tensors(value):
    """Every tensor field of ``value``: a tensor, a dataclass or a list of
    them (the shards of a placement)."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(value):
        for f in dataclasses.fields(value):
            yield from _tensors(getattr(value, f.name))


# ---------------------------------------------------------------- forwards
def signature(value):
    """What ``jax.jit`` keys a call on: the shape, dtype and device of
    every tensor in ``value`` (walked as ``static_like`` walks it, a
    batch's derived state included) and every other leaf's value."""
    if isinstance(value, torch.Tensor):
        return (tuple(value.shape), value.dtype, value.device)
    if isinstance(value, (list, tuple)):
        return (type(value).__name__,) + tuple(signature(v) for v in value)
    if dataclasses.is_dataclass(value):
        return ((type(value).__name__,)
                + tuple(signature(getattr(value, f.name))
                        for f in dataclasses.fields(value))
                + tuple((name, signature(getattr(value, name)))
                        for name in _derived(value)))
    return value


def clone_outputs(value):
    """A copy of a forward's outputs (a tensor, or a list or tuple of
    them) that the next replay cannot overwrite."""
    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, (list, tuple)):
        return type(value)(clone_outputs(v) for v in value)
    return value


class GraphPool:
    """One CUDA memory pool per device for the captured forwards of one
    owner (a service, a run, one call)."""

    def __init__(self):
        self.handles: dict = {}

    def handle(self, device):
        device = torch.device(device)
        if device not in self.handles:
            self.handles[device] = torch.cuda.graph_pool_handle()
        return self.handles[device]

    def reserved_bytes(self) -> Optional[int]:
        """The bytes the pools' segments hold on the card (the caching
        allocator's snapshot); None where this PyTorch's snapshot does
        not name segments' pools."""
        return _pool_bytes({tuple(h) for h in self.handles.values()})


class ForwardCache:
    """desco_tpu's ``_jit_*`` cache of compiled forwards. ``cache(fn,
    inputs, static=..., group=...)`` returns ``fn(*inputs)``: a clone of
    the outputs of the forward (``GraphedStep(..., inference=True)``) made
    for ``static`` (what ``fn`` depends on besides its inputs: a config, a
    parameter module, the bounds' schedules) and the inputs' signature,
    from this call's ``fn`` and inputs at the first call of that key:
    captured on a CUDA device, static buffers without a capture on the
    CPU. A new key of the same ``static`` and ``group`` (on the inputs'
    device) drops the forward it replaces: a serving bucket grown to
    larger caps. The forwards share ``pool``; ``lock``, which an owner's
    caches share, is held around every capture and call, so two threads
    never replay one forward's buffers at once. ``capture_s`` sums the
    captures' seconds. ``replicas``: the replicas' parameter copies
    (parallel/dp.ReplicaParams) the DP predicts keep with the cache, whose
    graphs read their storage."""

    def __init__(self, pool: Optional[GraphPool] = None, lock=None):
        self.pool = pool if pool is not None else GraphPool()
        self.lock = lock if lock is not None else threading.RLock()
        self.replicas = None
        self.entries: dict = {}
        self.groups: dict = {}
        self.captures = 0
        self.capture_s = 0.0

    def __call__(self, fn: Callable, inputs: tuple, *, static=(),
                 group=None):
        inputs = tuple(inputs)
        dev = _device_of(inputs)
        key = (static, signature(inputs))
        with self.lock:
            entry = self.entries.get(key)
            if entry is None:
                slot = (static, group, dev)
                if group is not None:
                    self.entries.pop(self.groups.pop(slot, None), None)
                on_card = dev.type == "cuda"
                entry = GraphedStep(
                    lambda xs: fn(*xs), inputs, capture=on_card,
                    pool=self.pool.handle(dev) if on_card else None,
                    inference=True)
                self.entries[key] = entry
                if group is not None:
                    self.groups[slot] = key
                self.captures += 1
                trace.add("captures", 1)
                self.capture_s += entry.capture_s
            return clone_outputs(entry(inputs))


class ServingGraphs:
    """The compiled forwards of one service or run: one ``ForwardCache``
    per ensemble member (its neighborhood forward, over every replica),
    one for the bounds and one for the gossip forward, in one memory pool
    and under one lock."""

    def __init__(self, n_members: int):
        self.pool = GraphPool()
        self.lock = threading.RLock()
        self.members = [ForwardCache(self.pool, self.lock)
                        for _ in range(n_members)]
        self.bounds = ForwardCache(self.pool, self.lock)
        self.gossip = ForwardCache(self.pool, self.lock)

    def caches(self) -> list:
        return self.members + [self.bounds, self.gossip]

    def stats(self) -> dict:
        """Forwards held and captured, capture seconds, the pool's bytes
        (None where not reported)."""
        caches = self.caches()
        return {"forwards": sum(len(c.entries) for c in caches),
                "captures": sum(c.captures for c in caches),
                "capture_s": sum(c.capture_s for c in caches),
                "pool_bytes": (self.pool.reserved_bytes()
                               if self.pool.handles else 0)}
