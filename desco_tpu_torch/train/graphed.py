"""The compiled training step: the port's counterpart of desco_tpu's
``jax.jit(carried_step, donate_argnums=0)`` and ``eval_jit``
(desco_tpu/train/loop.py:148-166).

desco_tpu compiles each step once per shape and feeds it one resident
batch after another. Here a step is captured once per run and shape as a
``torch.cuda.CUDAGraph`` and replayed per batch:

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
    query embeddings and the learning rate into its buffers.

A failed capture or replay raises; nothing falls back to the eager step.
On the CPU, which only the tests ask for, the same static-buffer step runs
without a capture. ``no_sync`` runs the graphed loop under
``torch.cuda.set_sync_debug_mode("error")``, so a read-back left in a step
raises instead of stalling the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence

import torch

from ..models.shmp_gnn import BATCH_STATE
from ..ops import cuda_segment as cs

WARMUP_STEPS = 3


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
        for name in BATCH_STATE:
            if getattr(value, name, None) is not None:
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
        for name in BATCH_STATE:
            if getattr(dst, name, None) is not None:
                if getattr(src, name, None) is None:
                    raise ValueError(f"the batch has no {name}: derive it "
                                     f"before the loop (prepare_batch)")
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
    graph and every call replays it. ``fn`` returns nothing: it updates
    ``state`` (tensors) in place, which the warm-up before the capture
    leaves as it found them, and may draw from ``generators``."""

    def __init__(self, fn: Callable, example, *, capture: bool,
                 state: Sequence[torch.Tensor] = (),
                 generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.batch = static_like(example)
        self.graph = None
        self.record = cs.LaunchRecord()
        if capture:
            self._capture(list(state), list(generators))

    def _capture(self, state, generators) -> None:
        dev = _device_of(self.batch)
        counted = cs.read_launches()
        saved = [t.clone() for t in state]
        gen_states = [g.get_state() for g in generators]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
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
                        "the step draws from a generator (dropout above "
                        "0) and this PyTorch cannot register a generator "
                        "with a CUDA graph: train eagerly (graphed=False)")
                graph.register_generator_state(gen)
        with self.record.capture():
            with torch.cuda.graph(graph):
                self.fn(self.batch)
        cs.reset_launches()
        cs.add_launches(counted)
        self.graph = graph

    def __call__(self, batch) -> None:
        copy_into(self.batch, batch)
        if self.graph is None:
            self.fn(self.batch)
        else:
            self.graph.replay()
            self.record.replayed()


def placed_step_fn(body: Callable, reseed: Callable, opt, *,
                   graphed: bool) -> Callable:
    """A train step over data placed on the device for a run (a halo
    partition's shards, a DP x halo grid's replicas): ``step(params,
    place, query_embs, lr, seed=0) -> (loss, ok)`` calls ``reseed(place,
    seed)``, which reseeds the step's generators (made once) and returns
    them, then ``body(params, place, query_embs, lr) -> (loss, ok)``,
    which updates ``opt`` (train/loop.Adam) in place.

    ``graphed``: the body runs as a ``GraphedStep`` made at the first call
    for that call's ``params`` and ``place``, which later calls must pass
    again; the query embeddings and the learning rate (a float is filled
    into a device scalar) are its static buffers, and the loss and flag
    come back as copies of its outputs. It is captured where ``place``
    lies on one CUDA device and raises where it spans several; on the CPU
    it runs without a capture."""
    if not graphed:
        def step(params, place, query_embs, lr, seed=0):
            reseed(place, seed)
            return body(params, place, query_embs, lr)
        return step

    held = {}

    def step(params, place, query_embs, lr, seed=0):
        gens = reseed(place, seed)
        dev = query_embs.device
        if not isinstance(lr, torch.Tensor):
            lr = torch.full((), float(lr), device=dev)
        if not held:
            devices = {t.device for t in _tensors(place)}
            if dev.type == "cuda" and devices != {dev}:
                raise ValueError(f"a captured step runs on one card; its "
                                 f"data lies on {sorted(map(str, devices))}")
            out = (torch.zeros((), device=dev),
                   torch.zeros((), dtype=torch.bool, device=dev))

            def fn(batch):
                loss, ok = body(params, place, *batch)
                out[0].copy_(loss)
                out[1].copy_(ok)

            held.update(params=params, place=place, out=out,
                        step=GraphedStep(
                            fn, (query_embs, lr),
                            capture=dev.type == "cuda",
                            state=opt.state_tensors() + list(out),
                            generators=gens))
        elif params is not held["params"] or place is not held["place"]:
            raise ValueError("a graphed step replays over the parameters "
                             "and data of its first call")
        held["step"]((query_embs, lr))
        return held["out"][0].clone(), held["out"][1].clone()

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
