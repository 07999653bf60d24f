"""The SISS epilogue kernels' (``siss::``) time against their roofline: a
training microbatch makes one reduce and two backward launches over its
[rows, pixels] float32 operands (``portbench.roofline``)."""

import math

from portbench import roofline


def read(ctx):
    seconds = ctx.trace.seconds_where(lambda n: "siss::" in n)
    if seconds <= 0:
        return None
    rows, pixels = ctx.traffic["microbatch"], math.prod(ctx.family.image_shape(ctx.config["unet"]))
    per_step = ctx.traffic["accumulation"] * (roofline.siss_reduce(rows, pixels)
                                              + 2 * roofline.siss_bwd(rows, pixels))
    return 100.0 * ctx.units * per_step / seconds
