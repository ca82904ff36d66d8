"""Milliseconds of the gossip stages (host packing of the gossip batches
and the gossip forward with its read-back, both on the serving thread)
per graph served, from the benchmark's spans."""


def read(ctx):
    graphs = ctx.counters.get("graphs", 0)
    if not graphs or not ctx.spans_named("gossip_forward"):
        return None
    return 1e3 * (ctx.host_s("gossip_pack")
                  + ctx.host_s("gossip_forward")) / graphs
