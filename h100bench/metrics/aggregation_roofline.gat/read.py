"""The message aggregation's share of its roofline in the GAT train step,
in percent, as ``aggregation_roofline.train`` reckons SAGE's (see there),
over the device time of the kernels named under this metric's own
``patterns/``."""

from h100bench.lib import flops
from h100bench.lib.harness import patterns


def read(ctx):
    shapes = ctx.shapes.get("target", ())
    busy = ctx.device_s_matching(patterns("aggregation_roofline.gat"))
    if not shapes or busy <= 0:
        return None
    q = flops.query_shape()
    per_query = flops.aggregation_least_s(q, ctx.cfg, 2, False, ctx.peaks)
    least = sum(flops.aggregation_least_s(s, ctx.cfg, 6, True, ctx.peaks)
                + per_query for s in shapes)
    return 100.0 * least / busy
