"""The device's idle share of GAT training's traced window, in percent,
read as ``idle_share.train`` reads SAGE's (see there), under GAT's
end-to-end metric."""

from h100bench.lib.harness import load_reader

read = load_reader("idle_share.train")
