"""Host milliseconds per GAT train step, read as ``host_ms_per_step.train``
reads SAGE's (see there), under GAT's end-to-end metric."""

from h100bench.lib.harness import load_reader

read = load_reader("host_ms_per_step.train")
