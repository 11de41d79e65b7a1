"""Batcher worker: the share of the traced window it spent collecting a
batch after its first request, the linger (the program's
``batcher.linger`` spans, cut to the window), as a percent."""

from portbench import program_spans


def record():
    return program_spans.record()


def read(ctx):
    tl = program_spans.timeline(ctx)
    spans = tl.spans("batcher.linger") if tl else None
    return tl.share(sum(b - a for a, b, _ in spans)) if spans else None
