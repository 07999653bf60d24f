"""Device milliseconds a training step spends in the optimizer / foreach
kernel family (``portbench.trace.FAMILIES``): AdamW's multi-tensor
update, the EMA and the surgery's norms."""

from portbench.trace import family


def read(ctx):
    return 1e3 * ctx.trace.seconds_where(lambda n: family(n) == "optimizer / foreach") / ctx.units
