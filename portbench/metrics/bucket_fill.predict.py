"""Predictor: real query rows over the bucket rows (padding included) of
the window's ``predict.bucket`` spans, as a percent."""

from portbench import program_spans


def record():
    return program_spans.record()


def read(ctx):
    tl = program_spans.timeline(ctx)
    spans = tl.spans("predict.bucket") if tl else None
    if not spans:
        return None
    return 100.0 * sum(f["rows"] for _, _, f in spans) / sum(f["bucket"] for _, _, f in spans)
