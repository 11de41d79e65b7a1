"""Predictor: the mean time the card was busy inside a dispatched bucket's
``predict.bucket`` span (staging's copy, B2, ``_attach``, through the
fetch), from the profile's kernels, copies and sets under the span, ms.
None without a card."""

from portbench import program_spans


def record():
    return program_spans.record()


def read(ctx):
    tl = program_spans.timeline(ctx)
    spans = tl.spans("predict.bucket") if tl and tl.has_device else None
    if not spans:
        return None
    return sum(tl.busy_us(a, b) for a, b, _ in spans) / len(spans) / 1e3
