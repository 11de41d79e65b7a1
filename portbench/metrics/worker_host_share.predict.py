"""Batcher worker: the share of the traced window it spent dispatching
batches (``batcher.dispatch`` spans: deadline check, staging, the
predictor, fan-out) while the card ran nothing (the profile's busy time
inside each span taken off), as a percent: the worker's host work that
the card waits for."""

from portbench import program_spans


def record():
    return program_spans.record()


def read(ctx):
    tl = program_spans.timeline(ctx)
    idle = tl.idle_us("batcher.dispatch") if tl else None
    return tl.share(sum(idle)) if idle else None
