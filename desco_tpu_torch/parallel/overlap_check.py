"""Mechanical check that the halo exchange is free to overlap compute —
the port of ``desco_tpu/parallel/overlap_check.py``.

The claim (parallel/halo.py): the INTERIOR segment-sum stream of every
layer has no data dependence on that layer's PULL exchange, and the
BOUNDARY stream none on its PUSH exchange, so a schedule may run each
exchange while the independent local sum runs. desco_tpu proves it on
the traced jaxpr; here the function runs once under a
``TorchDispatchMode`` that sees every dispatched op. The steps of
``halo_typed_aggregate`` run inside ``torch.profiler.record_function``
ranges (halo_pull_L{k}, halo_interior_L{k}, halo_push_L{k},
halo_boundary_L{k}), whose enter and exit ops the mode sees too; it tags
the data each ``halo_pull_L{k}`` / ``halo_push_L{k}`` op produces,
spreads the tags through every op, and records a violation where an op
of a same-layer interior (boundary) region consumes a pull- (push-)
tagged tensor. It also fails if it saw no tagged pull and interior
region: a silent pass is not a pass.

Taints follow tensors by their memory: a tensor's key is its storage
address, offset, shape, strides and dtype, so a view gets the tags of the
op that made it, and an in-place write adds its tags to the whole
storage. Data an op makes in a pull or push region (an output that shares
no storage with the op's inputs) gets the region's tag; views made there
only carry their inputs' tags. Every tagged tensor is kept alive until
the check ends, so no address is reused under a stale tag.

The kernels' launches on the card bypass the dispatcher (they run
through ctypes), so a data flow through them would go unseen: the check
runs CPU tensors only (the plain versions, the same program) and raises
on any other device.
"""

from __future__ import annotations

import re
from typing import Dict, FrozenSet, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

Tag = Tuple[str, int]  # ("pull" | "push", layer)

_PULL_RE = re.compile(r"halo_pull_L(\d+)")
_PUSH_RE = re.compile(r"halo_push_L(\d+)")
_INT_RE = re.compile(r"halo_interior_L(\d+)")
_BND_RE = re.compile(r"halo_boundary_L(\d+)")

_EMPTY: FrozenSet[Tag] = frozenset()


class OverlapReport:
    def __init__(self):
        self.pull_layers = set()
        self.push_layers = set()
        self.interior_layers = set()
        self.boundary_layers = set()
        self.violations = []

    @property
    def ok(self) -> bool:
        return (not self.violations and bool(self.pull_layers)
                and bool(self.interior_layers))

    def summary(self) -> str:
        return (f"pull layers={sorted(self.pull_layers)} "
                f"push={sorted(self.push_layers)} "
                f"interior={sorted(self.interior_layers)} "
                f"boundary={sorted(self.boundary_layers)} "
                f"violations={self.violations or 'none'}")


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _key(t: torch.Tensor):
    return (_storage(t), t.storage_offset(), tuple(t.shape), t.stride(),
            t.dtype)


class _TaintMode(TorchDispatchMode):
    def __init__(self, rep: OverlapReport):
        super().__init__()
        self.rep = rep
        self.regions = []  # names of the open profiler ranges, nested
        self.tags: Dict[tuple, FrozenSet[Tag]] = {}
        self.storage_tags: Dict[int, FrozenSet[Tag]] = {}
        self.keep = []

    def _get(self, t: torch.Tensor) -> FrozenSet[Tag]:
        if t.numel() == 0:
            return _EMPTY
        return (self.tags.get(_key(t), _EMPTY)
                | self.storage_tags.get(_storage(t), _EMPTY))

    def _violate(self, what: str, op) -> None:
        v = (what, str(op))
        if v not in self.rep.violations:
            self.rep.violations.append(v)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.profiler._record_function_enter_new.default:
            self.regions.append(args[0])
            return func(*args, **kwargs)
        if func is torch.ops.profiler._record_function_exit._RecordFunction:
            self.regions.pop()  # ranges are context managers: they nest
            return func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(t.device.type != "cpu" for t in ins):
            raise ValueError(
                "check_halo_overlap runs CPU tensors: the kernels on the "
                "card launch past the dispatcher, out of the check's sight")
        in_t = _EMPTY
        for t in ins:
            in_t = in_t | self._get(t)
        stack = "/".join(self.regions)
        # the stream checks — the heart of the assertion
        for m in _INT_RE.finditer(stack):
            k = int(m.group(1))
            self.rep.interior_layers.add(k)
            if ("pull", k) in in_t:
                self._violate(f"interior_L{k} depends on pull_L{k}", func)
        for m in _BND_RE.finditer(stack):
            k = int(m.group(1))
            self.rep.boundary_layers.add(k)
            if ("push", k) in in_t:
                self._violate(f"boundary_L{k} depends on push_L{k}", func)
        made = _EMPTY
        for kind, regex, layers in (("pull", _PULL_RE, self.rep.pull_layers),
                                    ("push", _PUSH_RE, self.rep.push_layers)):
            m = regex.search(stack)
            if m:
                k = int(m.group(1))
                layers.add(k)
                made = made | {(kind, k)}

        out = func(*args, **kwargs)

        in_storages = {_storage(t) for t in ins if t.numel()}
        for t in _tensors(out):
            if t.numel() == 0:
                continue
            fresh = _storage(t) not in in_storages
            if fresh:  # new memory: forget what an earlier owner left
                self.storage_tags.pop(_storage(t), None)
            self.tags[_key(t)] = in_t | (made if fresh else _EMPTY)
            self.keep.append(t)
        # in-place writes and out= arguments taint their whole storage
        for i, arg in enumerate(func._schema.arguments):
            t = args[i] if i < len(args) else kwargs.get(arg.name)
            info = arg.alias_info
            if (info is not None and info.is_write
                    and isinstance(t, torch.Tensor) and t.numel()):
                s = _storage(t)
                self.storage_tags[s] = (self.storage_tags.get(s, _EMPTY)
                                        | in_t | made)
                self.keep.append(t)
        return out


def check_halo_overlap(fn, *args) -> OverlapReport:
    """Run ``fn(*args)`` once on CPU tensors and check the halo overlap
    structure. ``report.ok`` is True iff at least one tagged pull
    exchange and interior stream were seen AND no same-layer dependence
    violation exists. Raise-free on a violation: callers assert on
    ``.ok`` so failures print the summary."""
    rep = OverlapReport()
    with _TaintMode(rep):
        fn(*args)
    return rep
