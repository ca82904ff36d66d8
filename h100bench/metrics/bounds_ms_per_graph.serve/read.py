"""Device milliseconds of the combinatorial bounds (the device work that
starts inside the spans around ``stage_bounds``) per graph served."""


def read(ctx):
    graphs = ctx.counters.get("graphs", 0)
    if not graphs or not ctx.spans_named("bounds"):
        return None
    busy = ctx.device_s_in("bounds")
    return 1e3 * busy / graphs if busy > 0 else None
