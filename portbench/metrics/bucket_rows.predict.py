"""Batcher: mean query rows a dispatched batch in the window, from the
batcher's own row and batch counters."""


def read(ctx):
    b = ctx["batcher"]
    return b["rows"] / b["batches"] if b["batches"] else None
