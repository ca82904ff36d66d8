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
  * a data-parallel step (``ExchangedStep``) is two graphs, the
    process's own replicas' gradients and the ordered sum with the
    optimizer, and the exchange between them runs eagerly: across the
    ranks of a process group it is a gather, which no graph may hold.

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
static-buffer step or forward runs without a capture. ``no_sync`` runs
the graphed loop under ``torch.cuda.set_sync_debug_mode("error")``, so a
read-back left in a step raises instead of stalling the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import threading
import time
from typing import Callable, Optional, Sequence

import torch

from ..ops import cuda_segment as cs

WARMUP_STEPS = 3
# a forward's lazy set-up (kernel libraries and their shared-memory
# attributes, the towers' bias ids, cuBLAS handles) needs one call; the
# second checks that the first left nothing to set up
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
    must keep their storage. An empty ``example`` needs the ``device``."""

    def __init__(self, fn: Callable, example, *, capture: bool,
                 state: Sequence[torch.Tensor] = (),
                 generators: Sequence[torch.Generator] = (),
                 pool=None, inference: bool = False, device=None):
        self.fn = fn
        self.inference = inference
        with self._mode():
            self.batch = static_like(example)
        self.graph = None
        self.outputs = None
        self.record = cs.LaunchRecord()
        self.capture_s = 0.0
        if capture:
            self._capture(list(state), list(generators), pool, torch.device(
                device if device is not None else _device_of(self.batch)))

    def _mode(self):
        return (torch.inference_mode() if self.inference
                else contextlib.nullcontext())

    def _capture(self, state, generators, pool, dev) -> None:
        t0 = time.perf_counter()
        counted = cs.read_launches()
        saved = [t.clone() for t in state]
        gen_states = [g.get_state() for g in generators]
        with torch.cuda.device(dev), self._mode():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_FORWARDS if self.inference
                               else WARMUP_STEPS):
                    self.fn(self.batch)
            torch.cuda.current_stream(dev).wait_stream(side)
            for t, s in zip(state, saved):
                t.copy_(s)
            graph = torch.cuda.CUDAGraph()
            for gen, gen_state in zip(generators, gen_states):
                draws = not torch.equal(gen.get_state(), gen_state)
                gen.set_state(gen_state)
                if draws:
                    if not hasattr(graph, "register_generator_state"):
                        raise RuntimeError(
                            "the step draws from a generator (dropout "
                            "above 0) and this PyTorch cannot register a "
                            "generator with a CUDA graph: train eagerly "
                            "(graphed=False)")
                    graph.register_generator_state(gen)
            with self.record.capture(), no_collection():
                with torch.cuda.graph(graph, pool=pool):
                    self.outputs = self.fn(self.batch)
        cs.reset_launches()
        cs.add_launches(counted)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def __call__(self, batch):
        with self._mode():
            copy_into(self.batch, batch)
            if self.graph is None:
                return self.fn(self.batch)
            self.graph.replay()
            self.record.replayed()
            return self.outputs


class ExchangedStep:
    """A train step split at its reduction, ``step(batch, lr) -> (loss,
    ok)``: ``local(batch) -> terms`` (this process's replicas'
    objectives and gradients), ``exchange(terms)`` (every replica's
    terms: a collective across ranks, which no graph may hold, or the
    terms themselves in one process) and ``finish(terms, lr) -> (loss,
    ok)`` (the ordered sum and the optimizer's update of ``state`` in
    place). ``local`` and ``finish`` are each a ``GraphedStep``, made
    here on the static buffers of ``example`` (a batch) and of ``terms``
    (a tensor shaped as what the exchange returns), ``capture`` recording
    them as two CUDA graphs; the exchange runs eagerly between their
    replays. ``local`` may draw from ``generators``. The loss and flag
    come back as copies of the finish's outputs; a float ``lr`` is filled
    into a device scalar."""

    def __init__(self, local: Callable, exchange: Callable,
                 finish: Callable, example, terms: torch.Tensor, *,
                 capture: bool, state: Sequence[torch.Tensor] = (),
                 generators: Sequence[torch.Generator] = ()):
        self.exchange = exchange
        self.local = GraphedStep(local, example, capture=capture,
                                 generators=generators)
        dev = terms.device
        out = self.out = (torch.zeros((), device=dev),
                          torch.zeros((), dtype=torch.bool, device=dev))

        def fn(b):
            loss, ok = finish(*b)
            out[0].copy_(loss)
            out[1].copy_(ok)

        self.finish = GraphedStep(fn, (terms, torch.zeros((), device=dev)),
                                  capture=capture,
                                  state=list(state) + list(out))

    def __call__(self, batch, lr):
        terms = self.exchange(self.local(batch))
        if not isinstance(lr, torch.Tensor):
            lr = torch.full((), float(lr), device=terms.device)
        self.finish((terms, lr))
        return self.out[0].clone(), self.out[1].clone()


def placed_step_fn(body: Callable, reseed: Callable, opt, *,
                   graphed: bool, exchange: Callable, finish: Callable,
                   n_terms: Callable = len,
                   eager_when: Optional[Callable] = None) -> Callable:
    """A train step over data placed on the device for a run (a halo
    partition's shards, a DP x halo grid's replicas), split as
    ``ExchangedStep`` splits it: ``step(params, place, query_embs, lr,
    seed=0) -> (loss, ok)`` calls ``reseed(place, seed)``, which reseeds
    the step's generators (made once) and returns them, then
    ``body(params, place, query_embs) -> terms``, ``exchange(terms)``
    (``n_terms(place)`` rows [flat gradient, term]) and ``finish(terms,
    lr) -> (loss, ok)``, which updates ``opt`` (train/loop.Adam) in
    place.

    ``graphed``: the body and the finish run as an ``ExchangedStep`` made
    at the first call for that call's ``params`` and ``place``, which
    later calls must pass again; the query embeddings and the learning
    rate (a float is filled into a device scalar) are its static buffers,
    and the loss and flag come back as copies of its outputs. It is
    captured where ``place`` lies on one CUDA device and raises where it
    spans several; on the CPU it runs without a capture. Where
    ``eager_when(place)`` gives a reason (the body holds collectives,
    which no capture may), the step runs eager and says so once on
    standard error."""

    def eager(params, place, query_embs, lr, seed=0):
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
        if not held and eager_when is not None:
            why = eager_when(place)
            if why:
                print(f"{why}: the graphed step runs eager (a captured "
                      f"step cannot hold a collective)", file=sys.stderr,
                      flush=True)
                held.update(params=params, place=place, step=None)
        if held and held["step"] is None:
            return eager(params, place, query_embs, lr, seed)
        gens = reseed(place, seed)
        dev = query_embs.device
        if not held:
            devices = {t.device for t in _tensors(place)}
            if dev.type == "cuda" and devices != {dev}:
                raise ValueError(f"a captured step runs on one card; its "
                                 f"data lies on {sorted(map(str, devices))}")
            held.update(params=params, place=place, step=ExchangedStep(
                lambda b: body(params, place, b[0]), exchange, finish,
                (query_embs,), opt.flat.new_zeros(
                    (n_terms(place), opt.flat.numel() + 1)),
                capture=dev.type == "cuda",
                state=opt.state_tensors(), generators=gens))
        return held["step"]((query_embs,), lr)

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
        ids = {tuple(h) for h in self.handles.values()}
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot() if ids else ():
            pool = seg.get("segment_pool_id")
            if pool is None:
                continue
            named = True
            if tuple(pool) in ids:
                total += int(seg["total_size"])
        return total if named or not ids else None


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
