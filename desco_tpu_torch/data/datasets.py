"""Dataset loading for the training CLI — the port's part of
``desco_tpu/data/datasets.py``.

One family so far: ``SynNp_<n>[_<seed>]``, n random connected graphs from
the port's numpy generator (``data/synthetic.py``: Syn_1827's size and
density samplers over G(n, m) graphs), seed 0 unless given. The name
differs from desco_tpu's ``Syn_<n>`` on purpose: the graphs differ
(desco_tpu draws from networkx generators, which the GPU machine lacks),
and the ground-truth caches under ``<data_root>/<name>/`` must not
collide. The TU datasets, ``Syn_<n>`` and the ``_train/_val/_test``
splits are not ported yet (ROADMAP.md, Queue 1 M10).
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from ..graph.container import Graph
from .synthetic import random_connected_graphs

_SYN_NP = re.compile(r"SynNp_(\d+)(?:_(\d+))?")


def load_data(name: str, data_root: str = "data") -> List[Graph]:
    """The graphs of dataset ``name``. ``data_root`` is where a dataset
    read from files would live; ``SynNp`` is generated."""
    m = _SYN_NP.fullmatch(name)
    if m is None:
        raise NotImplementedError(
            f"dataset {name!r}: the port generates SynNp_<n>[_<seed>] "
            f"only; desco_tpu's other datasets are not ported yet "
            f"(ROADMAP.md, Queue 1 M10)")
    n_graphs, seed = int(m.group(1)), int(m.group(2) or 0)
    if n_graphs < 1:
        raise ValueError(f"dataset {name!r} has no graphs")
    return random_connected_graphs(n_graphs, np.random.default_rng(seed))
