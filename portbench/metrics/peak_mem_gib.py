"""The card's peak allocated memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
