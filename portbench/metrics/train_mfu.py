"""The training step's model FLOPs per second as a share of the peak of
the configuration's compute type: 5 forwards (one forward, two backward
pulls of twice a forward each) per image of the global batch, recomputation
not counted, over the mean host-clock time of the window's untraced steps
(each ends in a synchronise)."""

from portbench import roofline


def read(ctx):
    if not ctx.untraced_s:
        return None
    flops = roofline.TRAIN_FORWARDS * ctx.config["forward_flop_per_image"] * ctx.rows
    return 100.0 * flops / ctx.untraced_s / roofline.peak(ctx.config)
