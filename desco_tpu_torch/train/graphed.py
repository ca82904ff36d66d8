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
  * a step that draws from a generator (dropout above 0) needs the
    generator registered with the graph, where the card's PyTorch has
    ``CUDAGraph.register_generator_state``; without it the capture raises.

A failed capture or replay raises; nothing falls back to the eager step.
On the CPU, which only the tests ask for, the same static-buffer step runs
without a capture. ``no_sync`` runs the graphed loop under
``torch.cuda.set_sync_debug_mode("error")``, so a read-back left in a step
raises instead of stalling the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..models.shmp_gnn import BATCH_STATE
from ..ops import cuda_segment as cs

WARMUP_STEPS = 3


def static_like(value):
    """A copy of ``value`` (a batch, its streams, a tensor) with fresh
    tensors of the same shapes: the static buffers of a captured step.
    A batch's derived state comes along."""
    if isinstance(value, torch.Tensor):
        return value.clone()
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


class GraphedStep:
    """``fn(batch)`` over same-shape batches, on static buffers made from
    ``example``; ``capture`` (a CUDA device) records it once as a CUDA
    graph and every call replays it. ``fn`` returns nothing: it updates
    ``state`` (tensors) in place, which the warm-up before the capture
    leaves as it found them, and may draw from ``generator``."""

    def __init__(self, fn: Callable, example, *, capture: bool,
                 state: Sequence[torch.Tensor] = (),
                 generator: Optional[torch.Generator] = None):
        self.fn = fn
        self.batch = static_like(example)
        self.graph = None
        self.record = cs.LaunchRecord()
        if capture:
            self._capture(list(state), generator)

    def _capture(self, state, generator) -> None:
        dev = self.batch.x.device
        counted = cs.read_launches()
        saved = [t.clone() for t in state]
        gen_state = None if generator is None else generator.get_state()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.fn(self.batch)
        torch.cuda.current_stream(dev).wait_stream(side)
        for t, s in zip(state, saved):
            t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            draws = not torch.equal(generator.get_state(), gen_state)
            generator.set_state(gen_state)
            if draws:
                if not hasattr(graph, "register_generator_state"):
                    raise RuntimeError(
                        "the step draws from its generator (dropout above "
                        "0) and this PyTorch cannot register a generator "
                        "with a CUDA graph: train eagerly "
                        "(run_training(graphed=False))")
                graph.register_generator_state(generator)
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
