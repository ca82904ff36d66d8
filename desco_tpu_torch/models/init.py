"""Parameter containers and initializers (port of ``desco_tpu/models/init.py``).

Weights keep desco_tpu's layout: a ``Linear`` holds ``w`` as
[*lead, fan_in, fan_out] (applied as ``x @ w + b``) and ``b`` as
[*lead, fan_out], with optional leading axes per layer and per node or
edge type. Its state-dict keys ``<path>.w`` / ``<path>.b`` are the JAX
checkpoint keys ``<path>/0`` / ``<path>/1`` (train/checkpoint.py), so
checkpoints map one to one; a ``Tree`` is a dict node that may also hold
bare arrays.

Fresh weights follow torch.nn.Linear's default, U(-k, k) with
k = 1/sqrt(fan_in), drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class Linear(nn.Module):
    """A (w, b) pair in desco_tpu's layout (see module docs)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor) -> None:
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class Tree(nn.ModuleDict):
    """A dict node of desco_tpu's parameter tree: subtrees as modules and,
    where desco_tpu keeps a bare array beside them (PNA's ``pna_mix``
    beside ``conv``), that array as an ``nn.Parameter`` under the same
    key, so its state-dict key is ``<path>.pna_mix``. ``tree[key]`` and
    ``key in tree`` see both kinds."""

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return super().__getitem__(key)

    def __setitem__(self, key: str, value) -> None:
        if isinstance(value, nn.Parameter):
            self.register_parameter(key, value)
        else:
            super().__setitem__(key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or super().__contains__(key)


def linear_params(fan_in: int, fan_out: int, *lead: int,
                  generator: Optional[torch.Generator] = None) -> Linear:
    """Linear with optional leading axes (e.g. per edge/node type)."""
    k = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(*lead, fan_in, fan_out).uniform_(-k, k,
                                                     generator=generator)
    b = torch.empty(*lead, fan_out).uniform_(-k, k, generator=generator)
    return Linear(w, b)


def mlp_params(dims: Sequence[int], *lead: int,
               generator: Optional[torch.Generator] = None) -> nn.ModuleList:
    """Consecutive Linears dims[i] -> dims[i+1]."""
    return nn.ModuleList([
        linear_params(dims[i], dims[i + 1], *lead, generator=generator)
        for i in range(len(dims) - 1)])
