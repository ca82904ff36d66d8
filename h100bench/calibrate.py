"""Readings for the limits of ``correct``: the program's numbers over many
seeds, and the control's (the plain reference in TF32 in the program's
place) and the planted faults' on some of them, at the cell's own size,
in one process.

    python3 h100bench/calibrate.py --workload <cell> --seeds 1 2 3 ...
        [--control 3] [--seconds 3] [--out readings.jsonl]

Each seed is a whole run of the cell (set-up, a short window, the check);
the first ``--control`` seeds also read the control and the faults. Every
reading is judged against ``limits/<cell>.json`` as a run judges its
own (``lib/harness.judge``): the program has to come out correct, the
control and each fault not. One JSON line per seed, then a summary: the
largest program reading and the smallest control reading of each number,
and whether every judgement came out as it has to. The benchmark's own
runs never run this; PERF.md gives the readings the limits were set
from. Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from h100bench.lib import harness  # noqa: E402


def serve_readings(checked: dict) -> dict:
    """The serving control and fault, from what a run's check compared
    (the driver's ``reference``): ``control``, the reference in TF32 in
    the program's place, its graph counts aggregated as the service
    aggregates; ``fault_altered_count``, the program's answers with each
    graph's first count altered by one where it is produced."""
    from h100bench.drivers import serve
    from h100bench.reference import pipeline as ref

    args, ref_out, prog = checked["args"], checked["ref_out"], checked["prog"]
    sizes, lim = checked["sizes"], checked["node_limit"]
    low = ref.serve(*args, tf32=True)
    follow = ref.serve(*args, gossip_input=low["stage1"])
    control = serve.compare(low["stage1"], low["node"],
                            serve.graph_counts(low["node"], sizes), sizes,
                            ref_out, follow, lim)
    graph = prog["graph"].copy()
    graph[:, 0] += 1.0
    altered = serve.compare(prog["stage1"], prog["node"], graph, sizes,
                            ref_out, ref_out, lim)
    return {"control": control, "fault_altered_count": altered}


def train_readings(checked: dict) -> dict:
    """The training control and faults, from what a run's check compared:
    ``control``, the reference in TF32 in the program's place; faults in
    the reference put in the program's place: half of each batch left
    out (``fault_half_batch``), the loss altered by 1% where it is
    produced (``fault_altered_loss``; Adam's update is blind to its
    scale), the state left unchanged (``fault_unchanged``)."""
    from h100bench.drivers import train
    from h100bench.reference import pipeline as ref

    args, r = checked["args"], checked["r"]

    def as_prog(out):
        return {"losses": out["losses"],
                "grad": {k: v.cpu().numpy().astype(np.float64)
                         for k, v in out["grad"].items()},
                "delta": {k: v.cpu().numpy().astype(np.float64)
                          for k, v in out["delta"].items()}}

    good = as_prog(r)
    return {
        "control": train.compare(as_prog(ref.train(*args, tf32=True)), r),
        "fault_half_batch": train.compare(
            as_prog(ref.train(*args, half=True)), r),
        "fault_altered_loss": train.compare(dict(
            good, losses=[v * 1.01 for v in good["losses"]],
            grad={k: v * 1.01 for k, v in good["grad"].items()}), r),
        "fault_unchanged": train.compare(dict(
            good, grad={k: 0 * v for k, v in good["grad"].items()},
            delta={k: 0 * v for k, v in good["delta"].items()}), r),
    }


READINGS = {"serve": serve_readings, "train": train_readings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="h100bench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import importlib

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("calibrate.py needs a CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.getcwd()
    bench = harness.benchmark(root)
    entry, cfg, traffic = harness.cell_files(bench, root, args.workload)
    lim = harness.limits(args.workload)
    driver = importlib.import_module(
        f"h100bench.drivers.{traffic['driver']}")
    rows = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        out = driver.run(entry, cfg, traffic, seed, args.seconds, False,
                         device, t0, harness.BUILD_DIR)
        others = {}
        if i < args.control and out["reference"] is not None:
            others = READINGS[traffic["driver"]](out["reference"])
        out.pop("reference")
        row = {"seed": seed, "numbers": out["numbers"],
               "correct": harness.judge(out["numbers"], lim)["ok"]
               and out["failed"] == 0,
               "others": {k: {"numbers": v,
                              "correct": harness.judge(v, lim)["ok"]}
                          for k, v in others.items()},
               "worst_leaves": out["diagnostics"].get("worst_leaves"),
               "failed": out["failed"], "attempted": out["attempted"],
               "setup_s": out["metrics"]["setup_s"],
               "run_s": time.perf_counter() - t0}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del out, others
        torch.cuda.empty_cache()
    names = list(rows[0]["numbers"])
    kinds = sorted({k for r in rows for k in r["others"]})
    summary = {
        "workload": args.workload, "limits": lim,
        "program_max": {n: max(r["numbers"][n] for r in rows)
                        for n in names},
        "program_all_correct": all(r["correct"] for r in rows),
        "others_min": {k: {n: min(r["others"][k]["numbers"][n]
                                  for r in rows if k in r["others"])
                           for n in names} for k in kinds},
        "others_none_correct": {k: not any(
            r["others"][k]["correct"] for r in rows if k in r["others"])
            for k in kinds},
        "seeds": len(rows),
        "card": harness.card()}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
