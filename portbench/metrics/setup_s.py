"""Seconds from the harness's first line to the first timed step or
request: imports, the kernel library's build or load, weights and inputs
from the seed, and the loop's set-up."""


def read(ctx):
    return ctx.setup_s
