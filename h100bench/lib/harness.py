"""What every cell's run shares: the benchmark's files found by name, the
device record, the limits and the checks' report, the per-layer readers,
and the guard against JAX in the process."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from typing import Dict, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)
BUILD_DIR = os.path.join(BENCH_DIR, ".build")
FORBIDDEN = ("jax", "jaxlib", "flax", "desco_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_files(bench: dict, root: str, cell: str):
    """(the cell's entry, its configuration, its traffic mix), by name."""
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload named {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     entry["traffic"] + ".json"))
    return entry, cfg, traffic


def limits(cell: str) -> Dict[str, float]:
    return load_json(os.path.join(BENCH_DIR, "limits", cell + ".json"))


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the run may not load,
    compared whole (the port's own name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"nvidia_smi": out}


def device_record(torch, device, chips: int, trace_ctx=None) -> dict:
    rec = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if device.type == "cuda" else 0)}
    rec.update(card() if device.type == "cuda" else {})
    if trace_ctx is not None:
        rec["busy_s"] = trace_ctx.busy_s
        rec["window_s"] = trace_ctx.window_s
    return rec


def judge(numbers: Dict[str, float], lim: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} and whether every number is within its
    limit (a missing or non-finite number fails)."""
    out, ok = {}, True
    for name, limit in lim.items():
        v = numbers.get(name)
        good = v is not None and v == v and abs(v) != float("inf") \
            and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return {"ok": ok, "checks": out}


def report_checks(checks: dict) -> None:
    """The numbers compared, beside their limits, as the run's last lines
    on standard error."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)


def load_reader(name: str):
    """The per-layer metric ``name``'s reader, ``metrics/<name>/read.py``."""
    path = os.path.join(BENCH_DIR, "metrics", name, "read.py")
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def patterns(name: str) -> list:
    """The kernel name patterns of metric ``name``: every line of every
    ``.txt`` file under ``metrics/<name>/patterns/``."""
    d = os.path.join(BENCH_DIR, "metrics", name, "patterns")
    out = []
    for fn in sorted(os.listdir(d)) if os.path.isdir(d) else ():
        if fn.endswith(".txt"):
            with open(os.path.join(d, fn)) as f:
                out += [ln.strip() for ln in f
                        if ln.strip() and not ln.startswith("#")]
    return out


def driver_metric(values: Dict[str, float], name: str) -> float:
    """The driver's reading of the end-to-end metric ``name``: its own,
    or, for ``<base>.<qualifier>`` (the same quantity in some cells
    under a bound of its own), the driver's ``<base>``."""
    return values[name] if name in values else values[name.split(".", 1)[0]]


def cell_metrics(bench: dict, cell: str, kind: str, e2e: Optional[set]):
    """The names of the cell's metrics of ``kind`` ("end_to_end" or
    "per_layer"); a per-layer metric without a ``workloads`` key belongs
    to every cell that reports the end-to-end metric it moves."""
    out = []
    for m in bench[kind]:
        cells = m.get("workloads")
        if cells is not None:
            if cell in cells:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in (e2e or ()):
            out.append(m)
    return out
