"""Device milliseconds per GAT train step, read as
``device_ms_per_step.train`` reads SAGE's (see there), under GAT's
end-to-end metric."""

from h100bench.lib.harness import load_reader

read = load_reader("device_ms_per_step.train")
