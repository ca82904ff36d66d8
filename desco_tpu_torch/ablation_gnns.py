"""Ablation: SHMP against plain homogeneous GNNs — the port's counterpart
of desco_tpu's root ``ablation_gnns.py``.

The same two-stage pipeline as ``python -m desco_tpu_torch.main`` with
``--no-use_hetero --no-use_tconv``: one node type, one edge type,
canonical-ness carried only by a one-hot input feature. It takes every
flag of main, ``--neigh_conv_type SAGE|GIN|GCN|GAT|PNA`` and ``--device``
among them, and runs on the card unless ``--device cpu`` is given.

    python -m desco_tpu_torch.ablation_gnns --train_neigh --test_gossip \\
        --train_gossip --train_dataset Syn_1827 --valid_dataset Syn_1827 \\
        --test_dataset Syn_1827_test --neigh_conv_type GIN
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from .main import main as run_main

    argv = list(sys.argv[1:] if argv is None else argv)
    return run_main(argv + ["--no-use_hetero", "--no-use_tconv"])


if __name__ == "__main__":
    sys.exit(main())
