"""Finished images per second of the window's requests: all their images
over the span from the first start to the last end."""


def read(ctx):
    return ctx.images / ctx.elapsed
