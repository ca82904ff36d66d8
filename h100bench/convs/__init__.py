"""The message-passing layers of the SHMP towers, one module per
configuration ``conv_type``, ``convs/<conv_type>.py``, found by name.

A module holds everything the benchmark needs of its layer:

- ``leaves(prefix, h, L, n_node_types, n_edge_types)``: the weights it
  adds to a tower, as ``lib/weights`` specs;
- ``message(w, prefix, layer, t, h, src, dst, n)`` and
  ``update(w, prefix, layer, msg, h, ntype)``: the reference's arithmetic
  of one layer (the type-t message into every node, and the node's new
  state before the ReLU, from the messages summed over the types and the
  biases);
- ``layer_flops(s, h, n_types)``: one layer's model FLOPs over a batch of
  live shape ``s``;
- ``layer_least_s(s, h, n_types, fused, pk)``: the least time of one
  layer's message aggregation, forward and backward (``fused``: in the
  target tower, where the program may run a fused typed kernel).

A configuration whose ``conv_type`` has no module here is refused, so
that no layer is reckoned with another's reference or counts.
"""

from __future__ import annotations

import importlib
import os
import re


def load(conv_type: str):
    """The module of ``conv_type``; ValueError where there is none."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{conv_type}.py")
    if not re.fullmatch(r"[A-Za-z][A-Za-z0-9_]*", str(conv_type)) \
            or not os.path.isfile(path):
        raise ValueError(
            f"conv_type {conv_type!r}: no h100bench/convs/{conv_type}.py; "
            f"a new layer brings its weights, reference and counts there")
    return importlib.import_module(f"{__name__}.{conv_type}")
