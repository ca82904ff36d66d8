"""Device milliseconds per train step: the device's busy time over the
traced window (the union of its kernel and copy intervals) per step."""


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    if not steps or ctx.busy_s <= 0:
        return None
    return 1e3 * ctx.busy_s / steps
