"""Host milliseconds of request preparation (canonical decomposition,
triangle typing, packing: ``prepare_stage_data`` on the stream's
producer thread) per graph served, from the benchmark's spans."""


def read(ctx):
    spans = ctx.spans_named("prepare")
    graphs = sum(s.info.get("graphs", 0) for s in spans)
    if not graphs:
        return None
    return 1e3 * ctx.host_s("prepare") / graphs
