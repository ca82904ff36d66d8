"""Checkpoint loading — desco_tpu's ``.params.npz`` + ``.json`` pair, read
into the port's parameter modules.

desco_tpu (``desco_tpu/train/checkpoint.py``) saves a flat npz keyed by
pytree paths: ``target/conv/0`` is the [L, T, H, K] conv weight of the
target tower, ``target/conv/1`` its bias, ``convs/0/gate/1/0`` the second
gate layer's weight of gossip layer 0. Every (w, b) pair of the tree is
a path ending in ``/0`` and ``/1``; the port keeps the same tree as
``nn.Module``s (models/init.py), so ``<path>/0`` is the parameter
``<path>.w`` and ``<path>/1`` is ``<path>.b``. ``params_from_jax`` is the
one bridge: the release checkpoints and the parity tests (which flatten
desco_tpu parameters the same way) both go through it.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..models.init import Linear


def _build(node: dict, path: str) -> nn.Module:
    if set(node) == {"0", "1"} and all(
            isinstance(v, np.ndarray) for v in node.values()):
        return Linear(torch.from_numpy(np.array(node["0"], np.float32)),
                      torch.from_numpy(np.array(node["1"], np.float32)))
    if any(isinstance(v, np.ndarray) for v in node.values()):
        raise ValueError(f"checkpoint subtree {path or '/'} mixes arrays "
                         f"and subtrees: {sorted(node)}")
    if all(k.isdigit() for k in node):
        idx = sorted(int(k) for k in node)
        if idx != list(range(len(idx))):
            raise ValueError(f"checkpoint list {path} has gaps: {idx}")
        return nn.ModuleList([_build(node[str(i)], f"{path}/{i}")
                              for i in idx])
    return nn.ModuleDict({k: _build(v, f"{path}/{k}" if path else k)
                          for k, v in sorted(node.items())})


def params_from_jax(flat: Dict[str, np.ndarray]) -> nn.Module:
    """desco_tpu parameters, flattened as its checkpoints flatten them
    (``{"target/conv/0": array, ...}``), as the port's module tree."""
    tree: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(arr)
    return _build(tree, "")


def jax_key(state_dict_key: str) -> str:
    """The desco_tpu checkpoint key of one of the port's parameters."""
    *path, leaf = state_dict_key.split(".")
    return "/".join(path + [{"w": "0", "b": "1"}[leaf]])


def load_checkpoint(path: str) -> Tuple[nn.Module, dict]:
    """(parameter modules, metadata) of a checkpoint written by desco_tpu
    (``path + '.params.npz'`` and ``path + '.json'``)."""
    with np.load(path + ".params.npz") as npz:
        params = params_from_jax({k: npz[k] for k in npz.files})
    with open(path + ".json") as f:
        meta = json.load(f)
    return params, meta
