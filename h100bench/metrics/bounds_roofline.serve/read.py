"""The bounds' share of their roofline, in percent: the least time of
the bounds' work over the device time of every operation the stage runs.
The least time is counted from the served batches' live shapes
(``lib/flops.bounds_least_s``: the edge stream and node arrays read
once, [G, Q] written once, the tree DP's passes over the stream), the
same whatever implements the stage."""

from h100bench.lib import flops


def read(ctx):
    busy = ctx.device_s_in("bounds")
    shapes = [s for span in ctx.spans_named("prepare")
              for s in span.info.get("shapes", ())]
    if busy <= 0 or not shapes:
        return None
    steps = flops.tree_steps()
    q = int(ctx.counters["queries"])
    least = sum(flops.bounds_least_s(s, q, steps, ctx.peaks)
                for s in shapes)
    return 100.0 * least / busy
