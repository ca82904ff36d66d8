"""The message aggregation's share of its roofline in the train step, in
percent: the least time of every step's aggregation, forward and
backward, in both towers (``lib/flops.aggregation_least_s``, from the
batches' live shapes), over the device time of the kernels that do it,
found by the name patterns under ``patterns/``."""

from h100bench.lib import flops
from h100bench.lib.harness import patterns


def read(ctx):
    shapes = ctx.shapes.get("target", ())
    busy = ctx.device_s_matching(patterns("aggregation_roofline.train"))
    if not shapes or busy <= 0:
        return None
    q = flops.query_shape()
    per_query = flops.aggregation_least_s(q, ctx.cfg, 2, False, ctx.peaks)
    least = sum(flops.aggregation_least_s(s, ctx.cfg, 6, True, ctx.peaks)
                + per_query for s in shapes)
    return 100.0 * least / busy
