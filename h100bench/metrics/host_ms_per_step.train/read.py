"""Host milliseconds per train step: the wall clock around the loop's
step call, with no synchronize (copying the batch into the captured
step's buffers and launching its replay)."""


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    if not steps:
        return None
    return 1e3 * ctx.counters["host_step_s"] / steps
