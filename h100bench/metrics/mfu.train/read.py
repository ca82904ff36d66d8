"""Model FLOP utilization of training, in percent: every step's forward
and backward model FLOPs over the traced window (``lib/flops
.train_step_flops`` from the batches' live shapes), over the window,
against the card's float32 peak (float32, TF32 off)."""


def read(ctx):
    if not ctx.counters.get("steps") or ctx.window_s <= 0:
        return None
    return (100.0 * ctx.counters["flops"] / ctx.window_s
            / ctx.peaks["f32_flops_per_s"])
