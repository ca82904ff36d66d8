"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``. The cell
names its configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<mix>.json``, whose ``driver`` is the general generator that
reads it: ``serve`` or ``train`` under ``drivers/``). Set-up loads,
warms up every shape the cell uses and is timed as ``setup_s``; then the
window measures for ``--seconds``. ``--trace 0`` reports the cell's
end-to-end metrics (one named ``<base>.<qualifier>`` is the driver's
``<base>`` in the cells it lists, under a bound of its own); ``--trace 1`` runs the window under the device
profiler (for at most the mix's ``trace_seconds``) and reports its
per-layer metrics, each read by ``metrics/<name>/read.py``. After the
window the program's state is freed and the plain reference
(``reference/``) checks what the timed path produced; every number
compared is printed beside its limit (``limits/<cell>.json``) on
standard error and, as ``checks``, last in the result line.

Exits non-zero, printing no result, without a CUDA device (or fewer than
the cell asks for), or if JAX or the JAX package is loaded by the end.
The program's kernel and host-library builds go to ``h100bench/.build``
in the checkout, so a cell's later runs load them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from h100bench.lib import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="h100bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the build caches at fixed places inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(harness.BUILD_DIR, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(harness.BUILD_DIR, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    root = os.getcwd()
    bench = harness.benchmark(root)
    entry, cfg, traffic = harness.cell_files(bench, root, args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = execute(bench, entry, cfg, traffic, args.seed, args.seconds,
                     bool(args.trace), device, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded, and not allowed: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


def execute(bench: dict, entry: dict, cfg: dict, traffic: dict, seed: int,
            seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of the cell ``entry``: the result line as a dict."""
    import importlib

    import torch

    driver = importlib.import_module(
        f"h100bench.drivers.{traffic['driver']}")
    out = driver.run(entry, cfg, traffic, seed, seconds, trace, device,
                     t_start, harness.BUILD_DIR)
    out.pop("reference", None)
    judged = harness.judge(out["numbers"], harness.limits(entry["name"]))
    e2e = harness.cell_metrics(bench, entry["name"], "end_to_end", None)
    e2e_names = {m["name"] for m in e2e}
    metrics = {}
    ctx = out["context"]
    if trace:
        for m in harness.cell_metrics(bench, entry["name"], "per_layer",
                                      e2e_names):
            value = harness.load_reader(m["name"])(ctx) if ctx else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": harness.driver_metric(
                out["metrics"], m["name"]), "unit": m["unit"]}
    dev = harness.device_record(torch, device, entry["chips"],
                                ctx if trace else None)
    dev["memory_peak_bytes"] = out["memory_peak_bytes"]
    result = {"correct": judged["ok"] and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev,
              "diagnostics": dict(out["diagnostics"],
                                  numbers=out["numbers"])}
    if trace and ctx is not None:
        result["breakdown"] = ctx.counters.pop("breakdown")
    harness.report_checks(judged["checks"])
    result["checks"] = judged["checks"]
    return result


if __name__ == "__main__":
    raise SystemExit(main())
