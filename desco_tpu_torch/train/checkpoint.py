"""Checkpoints — desco_tpu's ``.params.npz`` + ``.json`` pair, read into
and written from the port's parameter modules.

desco_tpu (``desco_tpu/train/checkpoint.py``) saves a flat npz keyed by
pytree paths: ``target/conv/0`` is the [L, T, H, K] conv weight of the
target tower, ``target/conv/1`` its bias, ``convs/0/gate/1/0`` the second
gate layer's weight of gossip layer 0. Every (w, b) pair of the tree is
a path ending in ``/0`` and ``/1``; the port keeps the same tree as
``nn.Module``s (models/init.py), so ``<path>/0`` is the parameter
``<path>.w`` and ``<path>/1`` is ``<path>.b``. Two leaves are no (w, b)
pair: GAT's ``att`` is the pair (a_src, a_dst), kept as an
``nn.ParameterList`` (``<path>.att.0``, ``<path>.att.1`` for
``<path>/att/0``, ``<path>/att/1``), and PNA's ``pna_mix`` is a bare
array beside subtrees, kept as a parameter of the same name in its
``Tree`` node (``<path>.pna_mix``), as are the bare arrays of the
baselines' trees (DIAMNet's attention ``q`` ... ``g_b`` and LSTM ``wi``,
``wh``, ``b``; LRP's per-layer ``w``, ``b``), whose keys stay as they are
even where they read ``w`` or ``b``. ``params_from_jax`` is the one
bridge: the release checkpoints and the parity tests (which flatten
desco_tpu parameters the same way) both go through it, and
``save_checkpoint`` writes the same keys back (``jax_keys``), so
desco_tpu's ``load_checkpoint`` reads what the port saved.

The optimizer state goes to ``.opt.npz`` in a layout of the port's own
(desco_tpu's is optax's state tree and does not interchange): ``count`` is
the number of accepted Adam steps, ``mu/<key>`` and ``nu/<key>`` are the
first and second moments of the parameter with checkpoint key ``<key>``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.init import Linear, Tree

# tree keys whose two array leaves are a pair of their own, not a Linear's
# (w, b): GAT's attention vectors (a_src, a_dst), DIAMNet's layer norms
# (scale, bias)
PAIRS = ("att", "ln_q", "ln_k", "ln_v")


def _param(arr: np.ndarray) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(np.array(arr, np.float32)))


def _build(node: dict, path: str) -> nn.Module:
    arrays = {k: v for k, v in node.items() if isinstance(v, np.ndarray)}
    if set(node) == {"0", "1"} and len(arrays) == 2:
        if path.rsplit("/", 1)[-1] in PAIRS:
            return nn.ParameterList([_param(node["0"]), _param(node["1"])])
        return Linear(torch.from_numpy(np.array(node["0"], np.float32)),
                      torch.from_numpy(np.array(node["1"], np.float32)))
    if all(k.isdigit() for k in node) and not arrays:
        idx = sorted(int(k) for k in node)
        if idx != list(range(len(idx))):
            raise ValueError(f"checkpoint list {path} has gaps: {idx}")
        return nn.ModuleList([_build(node[str(i)], f"{path}/{i}")
                              for i in idx])
    if any(k.isdigit() for k in arrays):
        raise ValueError(f"checkpoint subtree {path or '/'} holds list "
                         f"items that are arrays: {sorted(node)}")
    # a dict node; a bare array beside subtrees (PNA's pna_mix) is a
    # parameter of the node under its own key
    tree = Tree()
    for k, v in sorted(node.items()):
        tree[k] = (_param(v) if isinstance(v, np.ndarray)
                   else _build(v, f"{path}/{k}" if path else k))
    return tree


def params_from_jax(flat):
    """desco_tpu parameters, flattened as its checkpoints flatten them
    (``{"target/conv/0": array, ...}``), as the port's module tree; a
    list of such dicts (the members of an ensemble) as a list of trees."""
    if isinstance(flat, (list, tuple)):
        return [params_from_jax(f) for f in flat]
    tree: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(arr)
    return _build(tree, "")


def jax_keys(params: nn.Module) -> Dict[str, str]:
    """{state-dict key: desco_tpu checkpoint key} of the port's
    parameters: a Linear's ``w`` / ``b`` are leaves ``0`` / ``1``; the
    items of a pair and the bare arrays of a ``Tree`` keep their keys."""
    out = {}
    for path, mod in params.named_modules():
        parts = path.split(".") if path else []
        for name, _ in mod.named_parameters(recurse=False):
            leaf = ({"w": "0", "b": "1"}[name] if isinstance(mod, Linear)
                    else name)
            out[".".join(parts + [name])] = "/".join(parts + [leaf])
    return out


def flatten_params(params: nn.Module) -> Dict[str, np.ndarray]:
    """The parameters under desco_tpu's checkpoint keys, as numpy."""
    keys = jax_keys(params)
    return {keys[k]: v.detach().cpu().numpy()
            for k, v in params.state_dict().items()}


def save_checkpoint(path: str, params: nn.Module,
                    config: Optional[dict] = None,
                    opt_state: Optional[Dict[str, np.ndarray]] = None,
                    extra: Optional[dict] = None) -> None:
    """Write ``path + '.params.npz'`` (desco_tpu's key layout) and
    ``path + '.json'`` ({"config", "extra"}); with ``opt_state`` (an
    optimizer's ``state_arrays()``) also ``path + '.opt.npz'``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".params.npz", **flatten_params(params))
    if opt_state is not None:
        np.savez(path + ".opt.npz", **opt_state)
    meta = {"config": config or {}, "extra": extra or {}}
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2, default=str)


def load_checkpoint(path: str, with_opt_state: bool = False):
    """(parameter modules, metadata) of a checkpoint written by desco_tpu
    or by the port (``path + '.params.npz'`` and ``path + '.json'``).
    ``with_opt_state=True`` returns (params, opt_state, metadata), where
    opt_state is the arrays of the port's ``.opt.npz`` or None when the
    file is missing."""
    with np.load(path + ".params.npz") as npz:
        params = params_from_jax({k: npz[k] for k in npz.files})
    with open(path + ".json") as f:
        meta = json.load(f)
    if not with_opt_state:
        return params, meta
    opt_state = None
    if os.path.exists(path + ".opt.npz"):
        with np.load(path + ".opt.npz") as npz:
            opt_state = {k: npz[k] for k in npz.files}
    return params, opt_state, meta
