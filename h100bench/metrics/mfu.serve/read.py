"""Model FLOP utilization of serving, in percent: the model FLOPs of the
neighborhood forward (target tower and count head; the query tower runs
once, when the service loads) and of the gossip forward over the
requests served in the traced window, counted from their batches' live
shapes (``lib/flops``), over the window, against the card's float32
peak (the configuration's precision: float32, TF32 off)."""

from h100bench.lib import flops


def read(ctx):
    q = int(ctx.counters.get("queries", 0))
    neigh = [s for span in ctx.spans_named("prepare")
             for s in span.info.get("shapes", ())]
    goss = [s for span in ctx.spans_named("gossip_pack")
            for s in span.info.get("shapes", ())]
    if not q or not neigh or ctx.window_s <= 0:
        return None
    h = ctx.cfg["neigh_hidden_dim"]
    total = sum(flops.tower_flops(s, ctx.cfg, 6)
                + flops.head_flops(s["g"], q, h) for s in neigh)
    total += sum(flops.gossip_flops(s, ctx.cfg, q) for s in goss)
    return 100.0 * total / ctx.window_s / ctx.peaks["f32_flops_per_s"]
