"""Shared helpers of the benchmark's CPU tests: a cell's run at a tiny
size on the CPU, through the same drivers, with the program's plain
kernels."""

import os
import time

from h100bench.lib import harness

REPO = os.path.dirname(harness.BENCH_DIR)
SEED = 2**31 + 11


def tiny(cell: str):
    """(bench, entry, cfg, traffic) of ``cell`` cut to a CPU test's size:
    a few small graphs, short windows; the widths are the cell's."""
    bench = harness.benchmark(REPO)
    entry, cfg, traffic = harness.cell_files(bench, REPO, cell)
    if traffic["driver"] == "serve":
        traffic.update(grid_nodes=[30, 34], pool_limit=12,
                       graphs_per_request=4, check_requests=2,
                       warm_check_requests=1, trace_seconds=1.0)
    else:
        traffic.update(grid_nodes=[10, 16], grid_modulus=1, grid_residue=0,
                       pool_limit=30, trace_seconds=1.0)
        cfg["neigh_batch_size"] = 32
    return bench, entry, cfg, traffic


def run_tiny(cell: str, trace: bool = False, seconds: float = 1.0,
             seed: int = SEED) -> dict:
    import torch

    from h100bench import run

    bench, entry, cfg, traffic = tiny(cell)
    return run.execute(bench, entry, cfg, traffic, seed, seconds, trace,
                       torch.device("cpu"), time.perf_counter())
