"""Share of the traced span in which no device op ran (the complement of
the union of kernel intervals): ``device_idle_pct.train`` over training
steps, ``device_idle_pct.sample`` over sampler calls."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
