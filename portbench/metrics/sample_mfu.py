"""The sampler's model FLOPs per second as a share of the peak of the
configuration's compute type: one forward per row of the UNet's batch (both
guidance halves), over the host-clock time of an untraced UNet call of the
traced request (the request's time less the traced calls' and the
profiler's, over its untraced calls)."""

from portbench import roofline


def read(ctx):
    if not ctx.untraced_s:
        return None
    flops = ctx.config["forward_flop_per_image"] * ctx.rows
    return 100.0 * flops / ctx.untraced_s / roofline.peak(ctx.config)
