"""Model FLOP utilization of GAT training, in percent, read as
``mfu.train`` reads SAGE's (see there), under GAT's end-to-end metric."""

from h100bench.lib.harness import load_reader

read = load_reader("mfu.train")
