"""desco_tpu's figures for chip_smoke.py's baseline drivers.

Runs desco_tpu's root ``baseline.py`` (JAX on the CPU) at chip_smoke.py's
phase-10 arguments (``Syn_1827_test_max40``, the defaults, 2 epochs,
seed 0), started from the weights that ``python -m
desco_tpu_torch.baseline`` draws for the same seed: the two packages draw
from different generators, so desco_tpu's ``init_lrp`` and
``init_diamnet_pipeline`` are swapped for the port's weights under
desco_tpu's keys. What follows is desco_tpu's own training and
evaluation. Prints one JSON line per baseline ({"baseline", "dataset",
"norm_mse", "mae"}); with ``--port`` the port's driver runs too, on the
CPU, and prints its own line after desco_tpu's (``--epoch_num`` other
than 2 shows how far the two drift apart with training).

    JAX_PLATFORMS=cpu python tests/baseline_reference.py \\
        --data_root "$(mktemp -d)" [--baseline LRP] [--port]

chip_smoke.py holds the card's normed MSE against the figures printed
here (``BASELINE_REFERENCE``).
"""

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the same arguments as chip_smoke.py's baselines_part
DATASET = "Syn_1827_test_max40"
EPOCHS = 2
SEED = 0


def _port_weights(kind, template, cfgs):
    """The port's seed-``SEED`` weights as a desco_tpu tree shaped like
    ``template``; a key or shape that does not map raises."""
    import jax
    import jax.numpy as jnp

    from desco_tpu.train.checkpoint import _flatten
    from desco_tpu_torch import baseline as tbaseline
    from desco_tpu_torch.train.checkpoint import flatten_params

    flat = flatten_params(tbaseline.init_params(kind, cfgs, SEED))
    want = _flatten(template)
    if set(flat) != set(want):
        raise KeyError(f"keys differ: {sorted(set(flat) ^ set(want))}")
    for k, v in want.items():
        if flat[k].shape != v.shape:
            raise ValueError(f"{k}: {flat[k].shape} != {v.shape}")
    treedef = jax.tree_util.tree_structure(template)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[k]) for k in want])


def reference(kind: str, data_root: str, epochs: int = EPOCHS) -> int:
    """desco_tpu's root baseline.py from the port's initial weights."""
    import baseline as jbaseline
    from desco_tpu.models import baseline_diamnet as jbd
    from desco_tpu.models import lrp as jlrp
    from desco_tpu_torch.models import baseline_diamnet as tbd
    from desco_tpu_torch.models import lrp as tlrp

    init_lrp, init_dn = jlrp.init_lrp, jbd.init_diamnet_pipeline

    def lrp_from_port(key, cfg, init="scaled"):
        port_cfg = tlrp.LRPConfig(**dataclasses.asdict(cfg))
        return _port_weights("LRP", init_lrp(key, cfg, init), (port_cfg,))

    def diamnet_from_port(key, tower, dn):
        port_cfgs = (tbd.diamnet_tower_config(tower.hidden_dim,
                                              tower.layer_num,
                                              tower.conv_type),
                     tbd.DIAMNetConfig(**dataclasses.asdict(dn)))
        return _port_weights("DIAMNET", init_dn(key, tower, dn), port_cfgs)

    jlrp.init_lrp, jbd.init_diamnet_pipeline = lrp_from_port, \
        diamnet_from_port
    try:
        return jbaseline.main(_argv(kind, os.path.join(data_root, "j"),
                                    epochs))
    finally:
        jlrp.init_lrp, jbd.init_diamnet_pipeline = init_lrp, init_dn


def _argv(kind: str, data_root: str, epochs: int):
    return ["--baseline", kind, "--train_dataset", DATASET, "--test_dataset",
            DATASET, "--epoch_num", str(epochs), "--seed", str(SEED),
            "--data_root", data_root]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--baseline", nargs="+", default=["DIAMNET", "LRP"],
                    choices=["DIAMNET", "LRP"])
    ap.add_argument("--port", action="store_true",
                    help="also run the port's driver on the CPU")
    ap.add_argument("--epoch_num", type=int, default=EPOCHS)
    args = ap.parse_args(argv)
    for kind in args.baseline:
        rc = reference(kind, args.data_root, args.epoch_num)
        if rc == 0 and args.port:
            from desco_tpu_torch import baseline as tbaseline

            rc = tbaseline.main(_argv(kind, os.path.join(args.data_root,
                                                         "t"),
                                      args.epoch_num)
                                + ["--device", "cpu"])
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
