"""The weights of a configuration, made on the device from the seed.

Both sides read the same numbers: the program through its checkpoint
files (``.params.npz`` under the checkpoint keys, and ``.json``) or its
parameter modules, the reference as a dict of tensors under the same
keys. A linear's weight is [*lead, fan_in, fan_out] and its bias
[*lead, fan_out], both U(-k, k) with k = 1 / sqrt(fan_in); a layer's
own leaves are its module's (``convs/<conv_type>.py``). All leaves of one model come from one uniform draw of
a ``torch.Generator`` on the device, split and scaled.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import convs

Spec = Tuple[str, Tuple[int, ...], float]

# target tower: node types (count, canonical), six triangle-typed edge
# types; query tower: one node type, two edge types (triangle, tride)
TARGET_TYPES = (2, 6)
QUERY_TYPES = (1, 2)


def linear(key: str, fan_in: int, fan_out: int, *lead: int) -> List[Spec]:
    k = 1.0 / math.sqrt(max(fan_in, 1))
    return [(f"{key}/0", (*lead, fan_in, fan_out), k),
            (f"{key}/1", (*lead, fan_out), k)]


def _tower(prefix: str, cfg: dict, n_node_types: int,
           n_edge_types: int) -> List[Spec]:
    h, L, f = (cfg["neigh_hidden_dim"], cfg["neigh_layer_num"],
               cfg["neigh_input_dim"])
    p = h * L + h
    out = linear(f"{prefix}/pre", f, h, n_node_types)
    out += linear(f"{prefix}/conv", h, h, L, n_edge_types)
    dims = [p, h, h, 256, h]
    for i in range(4):
        out += linear(f"{prefix}/post/{i}", dims[i], dims[i + 1])
    out += convs.load(cfg["conv_type"]).leaves(prefix, h, L, n_node_types,
                                               n_edge_types)
    out += linear(f"{prefix}/anchor", p, p)
    return out


def neighborhood_specs(cfg: dict) -> List[Spec]:
    """(key, shape, bound) of every leaf of the neighborhood model: the
    target and query towers and the count head."""
    if not (cfg["use_hetero"] and cfg["use_tconv"] and cfg["order"] == 3):
        raise ValueError("the benchmark runs the order-3 heterogeneous "
                         "model with triangle-typed edges")
    h = cfg["neigh_hidden_dim"]
    return (_tower("target", cfg, *TARGET_TYPES)
            + _tower("query", cfg, *QUERY_TYPES)
            + linear("count1", 2 * h, 4 * h) + linear("count2", 4 * h, 1))


def gossip_specs(cfg: dict) -> List[Spec]:
    """(key, shape, bound) of every leaf of the gossip model."""
    h, e = cfg["gossip_hidden_dim"], cfg["neigh_hidden_dim"]
    out = linear("pre", 1, h)
    d0 = h + e
    for layer in range(cfg["gossip_layer_num"]):
        d_in = d0 if layer == 0 else h
        out += linear(f"convs/{layer}/com", d_in, h)
        out += linear(f"convs/{layer}/upd", h + d_in, h)
        out += linear(f"convs/{layer}/gate/0", e, h)
        out += linear(f"convs/{layer}/gate/1", h, 1)
    dims = [h * cfg["gossip_layer_num"] + d0, h, h, 256, 1]
    for i in range(4):
        out += linear(f"post/{i}", dims[i], dims[i + 1])
    return out


def make_weights(specs: List[Spec], seed: int, stream: int,
                 device) -> Dict[str, torch.Tensor]:
    """{key: float32 tensor on ``device``}: one uniform draw from a
    generator on the device seeded by (seed, stream), split by ``specs``
    and scaled by each leaf's bound."""
    sizes = [int(np.prod(shape)) for _, shape, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(stream)) % (2**63 - 1))
    flat = torch.rand(sum(sizes), generator=gen, device=device,
                      dtype=torch.float32)
    flat = flat.mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for (key, shape, k), n in zip(specs, sizes):
        out[key] = flat[off:off + n].view(shape).mul_(k)
        off += n
    return out


def load_weights(path: str, device) -> Dict[str, torch.Tensor]:
    """{key: float32 tensor on ``device``} of a ``.params.npz`` file."""
    with np.load(path) as z:
        return {k: torch.as_tensor(np.asarray(z[k], np.float32),
                                   device=device) for k in z.files}


def save_checkpoint(path: str, weights: Dict[str, torch.Tensor],
                    config: dict) -> None:
    """Write ``path.params.npz`` and ``path.json``: the checkpoint format
    the program loads (arrays under the checkpoint keys; the pipeline
    config in the JSON's ``config``)."""
    np.savez(path + ".params.npz",
             **{k: v.detach().cpu().numpy() for k, v in weights.items()})
    with open(path + ".json", "w") as f:
        json.dump({"config": config, "extra": {}}, f)


def pipeline_config(cfg: dict) -> dict:
    """The configuration file's keys that the program's pipeline config
    takes."""
    keys = ("query_sizes", "depth", "use_hetero", "use_tconv", "order",
            "conv_type", "neigh_layer_num", "neigh_hidden_dim",
            "neigh_input_dim", "neigh_dropout", "neigh_batch_size",
            "neigh_lr", "neigh_weight_decay", "gossip_layer_num",
            "gossip_hidden_dim", "gossip_dropout", "gossip_batch_size",
            "gossip_lr", "gossip_weight_decay")
    return {k: cfg[k] for k in keys}
