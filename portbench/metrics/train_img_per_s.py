"""Images of the global batch per second of the window's training steps:
all its steps' images over its whole span, the last step ending in a
synchronise."""


def read(ctx):
    return ctx.images / ctx.elapsed
