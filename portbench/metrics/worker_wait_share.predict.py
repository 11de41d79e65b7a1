"""Batcher worker: the share of the traced window it spent blocked on an
empty queue for a batch's first request (the program's ``batcher.wait``
spans, cut to the window), as a percent."""

from portbench import program_spans


def record():
    return program_spans.record()


def read(ctx):
    tl = program_spans.timeline(ctx)
    spans = tl.spans("batcher.wait") if tl else None
    return tl.share(sum(b - a for a, b, _ in spans)) if spans else None
