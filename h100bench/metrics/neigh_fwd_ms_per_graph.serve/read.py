"""Device milliseconds of the neighborhood forward (the device work that
starts inside the spans around the stage-1 forward) per graph served."""


def read(ctx):
    graphs = ctx.counters.get("graphs", 0)
    if not graphs or not ctx.spans_named("neighborhood_forward"):
        return None
    busy = ctx.device_s_in("neighborhood_forward")
    return 1e3 * busy / graphs if busy > 0 else None
