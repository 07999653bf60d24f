"""Device milliseconds a training step spends in the elementwise and the
copy / cast kernel families (``portbench.trace.FAMILIES``)."""

from portbench.trace import family

FAMILIES = ("elementwise", "copies / casts")


def read(ctx):
    return 1e3 * ctx.trace.seconds_where(lambda n: family(n) in FAMILIES) / ctx.units
